"""Utilities: introspection, phonemization, plotting, TensorBoard events."""

from asr_dfcnn_transformer_torch.utils.introspect import attention_maps  # noqa: F401
from asr_dfcnn_transformer_torch.utils.plotting import (  # noqa: F401
    plot_freq, plot_spectrogram, plot_time, save_figure, wav_show)
from asr_dfcnn_transformer_torch.utils.phoneme import (  # noqa: F401
    HanziPhonemizer, phoneme_inventory, phonemize_pinyin, split_pinyin)
