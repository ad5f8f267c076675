"""Waveform / spectrum / spectrogram plot helpers: the port's own copy of
the JAX package's ``utils/plotting.py`` (numpy; matplotlib imported
inside each helper).


Counterparts of the reference's matplotlib helpers in
``util/wav_util.py:115-148`` (``wav_show``, ``plot_time``, ``plot_freq``,
``plot_spectrogram``) — the last SURVEY §2 items without a home. Same
visual semantics (time-axis seconds, rFFT dB magnitude, pcolor heatmap
with colorbar), reshaped into functions that return the Figure instead of
mutating implicit pyplot state, so they compose with notebooks, tests,
and file export alike.

matplotlib is an optional dependency: importing this module is free, and
each helper raises a clear ImportError only when actually called without
matplotlib installed.
"""

from __future__ import annotations

import numpy as np

__all__ = ["wav_show", "plot_time", "plot_freq", "plot_spectrogram",
           "save_figure"]


def _plt():
    try:
        import matplotlib
        try:
            import matplotlib.pyplot as plt
        except Exception:
            # never require a display: when the configured GUI backend is
            # unusable (CI, servers, a headless GPU host) fall back to Agg
            matplotlib.use("Agg", force=True)
            import matplotlib.pyplot as plt
        return plt
    except ImportError as e:  # pragma: no cover - environment dependent
        raise ImportError(
            "matplotlib is required for asr_dfcnn_transformer_torch.utils."
            "plotting (optional dependency)") from e


def wav_show(wave_data, sample_rate: int, ax=None):
    """Plot a waveform against seconds (wav_util.py:115-117).

    Returns the matplotlib Axes.
    """
    plt = _plt()
    wave_data = np.asarray(wave_data)
    if ax is None:
        _, ax = plt.subplots()
    t = np.arange(len(wave_data)) * (1.0 / sample_rate)
    ax.plot(t, wave_data)
    return ax


def plot_time(signal, sample_rate: int, figsize=(20, 5)):
    """Time-domain plot with labels/grid (wav_util.py:120-126).

    Returns the Figure.
    """
    plt = _plt()
    signal = np.asarray(signal)
    fig, ax = plt.subplots(figsize=figsize)
    t = np.arange(len(signal)) * (1.0 / sample_rate)
    ax.plot(t, signal)
    ax.set_xlabel("Time(s)")
    ax.set_ylabel("Amplitude")
    ax.grid(True)
    return fig


def plot_freq(signal, sample_rate: int, fft_size: int = 512,
              figsize=(20, 5)):
    """rFFT magnitude spectrum in dB (wav_util.py:130-138).

    Returns the Figure.
    """
    plt = _plt()
    signal = np.asarray(signal, dtype=np.float64)
    xf = np.fft.rfft(signal, fft_size) / fft_size
    freqs = np.linspace(0, sample_rate / 2, fft_size // 2 + 1)
    xfp = 20 * np.log10(np.clip(np.abs(xf), 1e-20, 1e100))
    fig, ax = plt.subplots(figsize=figsize)
    ax.plot(freqs, xfp)
    ax.set_xlabel("Freq(hz)")
    ax.set_ylabel("dB")
    ax.grid(True)
    return fig


def plot_spectrogram(spec, note: str = "Filterbank", figsize=(20, 5)):
    """Heatmap of a [T, F] feature matrix (wav_util.py:142-148).

    Accepts numpy arrays or CPU tensors (e.g. ``audio.fbank.logfbank`` output or
    an attention map from ``utils.introspect.attention_maps``). The
    reference plots time on x via ``plt.pcolor(spec)`` on an already
    [F, T]-oriented array; here a [T, F] array is transposed to match
    that orientation. Returns the Figure.
    """
    plt = _plt()
    spec = np.asarray(spec)
    if spec.ndim != 2:
        raise ValueError(f"spec must be 2-D [T, F], got {spec.shape}")
    fig, ax = plt.subplots(figsize=figsize)
    heatmap = ax.pcolormesh(spec.T)
    fig.colorbar(heatmap, ax=ax)
    ax.set_xlabel("Time(s)")
    ax.set_ylabel(note)
    fig.tight_layout()
    return fig


def save_figure(fig, path: str, dpi: int = 100) -> str:
    """Write a Figure to ``path`` and close it. Returns ``path``."""
    fig.savefig(path, dpi=dpi)
    _plt().close(fig)
    return path
