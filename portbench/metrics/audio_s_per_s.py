"""Seconds of audio transcribed per second of wall time: all the audio of
the batches completed in the window, over the window."""


def read(rec):
    if "audio_s" not in rec or rec["window_s"] <= 0:
        return None
    return rec["audio_s"] / rec["window_s"]
