"""Special token ids and the acoustic model's geometry.

The port's own copy of the JAX package's ``core/constants.py`` (the port
imports nothing of that package); the values must stay equal, which
``tests/test_torch_pipeline.py`` checks.
"""

from __future__ import annotations

import os

# Label-side special ids (reference util/const.py:35-41).
IGNORE_ID = -1
PAD = 0
SOS = 1
EOS = 2

PAD_FLAG = "<pad>"
SOS_FLAG = "<sos>"
EOS_FLAG = "</sos>"  # the reference uses "</sos>" as its EOS string flag

# The CTC blank is the LAST index of the acoustic vocabulary (the '_'
# appended after mixdict.txt's entries).
BLANK_SYMBOL = "_"

FEATURE_MAX_LENGTH = 1600  # max input frames (~16 s at 10 ms hop)
FEATURE_DIM = 200          # log-filterbank bins
TIME_REDUCTION = 8         # three 2x2 poolings => 1600 -> 200 frames
MAX_LABEL_LENGTH = 64      # pinyin/hanzi label cap

# Vocabulary files bundled with the port (copies of the JAX package's).
ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets")
PINYIN_DICT_PATH = os.path.join(ASSET_DIR, "mixdict.txt")
HANZI_DICT_PATH = os.path.join(ASSET_DIR, "hanzi.txt")
