"""Keras ``.hdf5`` weights of the reference's ``cnn_ctc`` and ``cnn_rnn_ctc``
acoustic models, in and out: the port's own copy of
``infer/hdf5_import.py`` (numpy and h5py only, as there).

The reference ships its best acoustic models as Keras weight files
(``model_05.7.64.hdf5``, ``model_04-14.91.hdf5``, README.md:21-23), loaded
at ``cnn_ctc.py:85-86``. :func:`load_keras_dfcnn_hdf5` maps one onto the
Flax variable tree of ``KerasDFCNN`` (``{"params": ..., "batch_stats":
...}`` of numpy arrays), which ``convert.am_state_dict`` turns into the
port's ``KerasDFCNN`` state_dict; :func:`save_keras_dfcnn_hdf5` writes such
a tree (``convert.state_dict_to_flax``) back as a Keras weights file.
:func:`load_keras_bigru_hdf5` / :func:`save_keras_bigru_hdf5` do the same
for ``BiGRUCTC(keras_parity=True)`` (``convert.bigru_state_dict``).

Layout facts used:

- Keras HDF5 stores per-layer groups under ``model_weights`` with weight
  names like ``conv2d_3/kernel:0``; layers are ordered by the
  ``layer_names`` / ``weight_names`` attributes.
- Keras Conv2D kernels are [H, W, in, out] and Dense kernels [in, out], as
  in Flax.
- Keras BatchNormalization stores gamma / beta / moving_mean /
  moving_variance: Flax's params scale / bias and batch_stats mean / var.
- The Keras model's softmax output is dropped: the head emits raw logits.

``h5py`` is imported inside the functions, so the package imports where it
is missing; there they raise an ``ImportError`` that names it.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("Keras .hdf5 weights need the h5py package, "
                          "which is not installed") from e
    return h5py


def _collect_layers(h5) -> Dict[str, List[np.ndarray]]:
    """Return {layer_name: [arrays in stored order]} from a Keras weights
    file (handles both 'model_weights' wrappers and flat files)."""
    root = h5["model_weights"] if "model_weights" in h5 else h5
    out = {}

    def attr_names(g, key):
        names = g.attrs.get(key)
        if names is None:
            return None
        return [n.decode() if isinstance(n, bytes) else n for n in names]

    layer_names = attr_names(root, "layer_names")
    if layer_names is None:
        layer_names = list(root.keys())
    for lname in layer_names:
        g = root[lname]
        wnames = attr_names(g, "weight_names")
        if wnames is None:
            # walk nested group
            wnames = []

            def walk(gg, prefix=""):
                for k in gg:
                    item = gg[k]
                    if hasattr(item, "shape"):
                        wnames.append(prefix + k)
                    else:
                        walk(item, prefix + k + "/")
            walk(g)
        if wnames:
            out[lname] = [np.asarray(g[w]) for w in wnames]
    return out


def _by_index(layers: Dict[str, List[np.ndarray]], prefix: str):
    return [layers[k] for k in sorted(
        (k for k in layers if k.startswith(prefix)),
        key=lambda k: int(k.split("_")[-1]) if k[-1].isdigit() else -1)]


def load_keras_dfcnn_hdf5(path: str, vocab_size: int,
                          dense_units: int = 128):
    """Load a cnn_ctc-layout Keras weight file into KerasDFCNN variables.

    Returns a Flax-layout variables dict {'params': ..., 'batch_stats':
    ...} of numpy arrays, for ``convert.am_state_dict``.
    """
    h5py = _h5py()
    with h5py.File(path, "r") as f:
        layers = _collect_layers(f)

    convs = _by_index(layers, "conv2d")
    bns = _by_index(layers, "batch_normalization")
    denses = _by_index(layers, "dense")
    if len(convs) != 10 or len(bns) != 10 or len(denses) < 2:
        raise ValueError(
            f"unexpected cnn_ctc layout: {len(convs)} convs, {len(bns)} "
            f"BNs, {len(denses)} denses (want 10/10/2)")

    params: Dict = {}
    batch_stats: Dict = {}
    for i in range(10):
        kernel, bias = convs[i][0], convs[i][1]
        gamma, beta, mean, var = bns[i]
        cell = f"ConvBnCell_{i}"
        params[cell] = {
            "Conv_0": {"kernel": kernel, "bias": bias},
            "BatchNorm_0": {"scale": gamma, "bias": beta},
        }
        batch_stats[cell] = {
            "BatchNorm_0": {"mean": mean, "var": var},
        }
    params["Dense_0"] = {"kernel": denses[0][0], "bias": denses[0][1]}
    params["Dense_1"] = {"kernel": denses[1][0], "bias": denses[1][1]}
    out_dim = denses[1][0].shape[1]
    if out_dim != vocab_size:
        raise ValueError(f"checkpoint vocab {out_dim} != expected "
                         f"{vocab_size}")
    if denses[0][0].shape[1] != dense_units:
        raise ValueError(f"checkpoint dense width {denses[0][0].shape[1]} "
                         f"!= expected {dense_units}")
    return {"params": params, "batch_stats": batch_stats}


def _sorted_by_index(layers: Dict[str, List[np.ndarray]], prefix: str):
    """Layers named ``prefix`` / ``prefix_N`` (TF2, 0-based) or
    ``prefix_1..`` (Keras 2, 1-based), sorted by creation index."""
    keys = [k for k in layers
            if k == prefix or (k.startswith(prefix + "_")
                               and k[len(prefix) + 1:].isdigit())]
    return [layers[k] for k in sorted(
        keys, key=lambda k: int(k.split("_")[-1]) if k[-1].isdigit() else -1)]


def hdf5_bigru_hidden(path: str) -> int:
    """The hidden width of a cnn_rnn_ctc weight file (its first GRU's
    kernel is [F, 3H])."""
    h5py = _h5py()
    with h5py.File(path, "r") as f:
        grus = _sorted_by_index(_collect_layers(f), "gru")
    if not grus:
        raise ValueError(f"{path!r} holds no GRU layer")
    return grus[0][0].shape[1] // 3


def load_keras_bigru_hdf5(path: str, vocab_size: int,
                          hidden: int | None = None):
    """Load a cnn_rnn_ctc-layout Keras weight file into
    ``BiGRUCTC(keras_parity=True)`` variables ({"params": ...} of numpy
    arrays, for ``convert.bigru_state_dict``).

    Creation order (cnn_rnn_ctc.py:37-47): Dense 512 x2, then per layer a
    forward GRU and a ``go_backwards`` GRU, then Dense 512 and Dense
    vocab. Each Keras GRU stores [kernel [F, 3H], recurrent_kernel
    [H, 3H], bias [3H]], gates [z | r | h], taken as they are. ``hidden``
    None reads the width from the file.
    """
    h5py = _h5py()
    with h5py.File(path, "r") as f:
        layers = _collect_layers(f)
    denses = _sorted_by_index(layers, "dense")
    grus = _sorted_by_index(layers, "gru")
    if len(denses) != 4 or len(grus) != 6:
        raise ValueError(
            f"unexpected cnn_rnn_ctc layout: {len(denses)} denses, "
            f"{len(grus)} GRUs (want 4/6)")
    if denses[3][0].shape[1] != vocab_size:
        raise ValueError(f"checkpoint vocab {denses[3][0].shape[1]} != "
                         f"expected {vocab_size}")
    if hidden is None:
        hidden = grus[0][0].shape[1] // 3
    if grus[0][0].shape[1] != 3 * hidden:
        raise ValueError(f"checkpoint hidden {grus[0][0].shape[1] // 3} != "
                         f"expected {hidden}")
    params: Dict = {}
    for i, d in enumerate(denses):
        params[f"Dense_{i}"] = {"kernel": d[0], "bias": d[1]}
    for layer in range(3):
        for j, kind in enumerate(("fwd", "bwd")):
            kernel, rec, bias = grus[2 * layer + j]
            params[f"gru_{kind}_{layer}"] = {
                "kernel": kernel, "recurrent_kernel": rec, "bias": bias}
    return {"params": params}


def save_keras_bigru_hdf5(path: str, variables, vocab_size: int,
                          hidden: int = 512) -> None:
    """Inverse of :func:`load_keras_bigru_hdf5` (Keras 2's 1-based layer
    names, as the reference's ``model.save_weights`` writes them)."""
    h5py = _h5py()
    p = variables["params"]
    if np.asarray(p["Dense_3"]["kernel"]).shape[1] != vocab_size:
        raise ValueError("vocab mismatch")
    if np.asarray(p["gru_fwd_0"]["kernel"]).shape[1] != 3 * hidden:
        raise ValueError("hidden mismatch")
    with h5py.File(path, "w") as f:
        mw = f.create_group("model_weights")
        layer_names = []

        def put(lname: str, names_arrays):
            g = mw.create_group(lname)
            wnames = []
            for suffix, arr in names_arrays:
                wname = f"{lname}/{suffix}:0"
                g.create_dataset(wname, data=np.asarray(arr, np.float32))
                wnames.append(wname)
            g.attrs["weight_names"] = np.array([n.encode() for n in wnames])
            layer_names.append(lname)

        def put_dense(idx: int, flax_name: str):
            put(f"dense_{idx}", [("kernel", p[flax_name]["kernel"]),
                                 ("bias", p[flax_name]["bias"])])

        def put_gru(idx: int, flax_name: str):
            put(f"gru_{idx}",
                [("kernel", p[flax_name]["kernel"]),
                 ("recurrent_kernel", p[flax_name]["recurrent_kernel"]),
                 ("bias", p[flax_name]["bias"])])

        put_dense(1, "Dense_0")
        put_dense(2, "Dense_1")
        for layer in range(3):
            put_gru(2 * layer + 1, f"gru_fwd_{layer}")
            put_gru(2 * layer + 2, f"gru_bwd_{layer}")
        put_dense(3, "Dense_2")
        put_dense(4, "Dense_3")
        mw.attrs["layer_names"] = np.array([n.encode() for n in layer_names])


def save_keras_dfcnn_hdf5(path: str, variables, vocab_size: int,
                          dense_units: int = 128) -> None:
    """Inverse of :func:`load_keras_dfcnn_hdf5`: write KerasDFCNN variables
    as a Keras-layout weights file (model_weights/<layer>/<name>:0 with
    layer_names/weight_names attrs), so models trained here can be handed
    back to the reference's Keras stack (cnn_ctc.py:85-86)."""
    h5py = _h5py()
    p, bs = variables["params"], variables["batch_stats"]
    if np.asarray(p["Dense_1"]["kernel"]).shape[1] != vocab_size:
        raise ValueError("vocab mismatch")
    if np.asarray(p["Dense_0"]["kernel"]).shape[1] != dense_units:
        raise ValueError("dense width mismatch")
    with h5py.File(path, "w") as f:
        mw = f.create_group("model_weights")
        layer_names = []

        def put(lname: str, names_arrays):
            g = mw.create_group(lname)
            wnames = []
            for suffix, arr in names_arrays:
                wname = f"{lname}/{suffix}:0"
                g.create_dataset(wname, data=np.asarray(arr, np.float32))
                wnames.append(wname)
            g.attrs["weight_names"] = np.array([n.encode() for n in wnames])
            layer_names.append(lname)

        for i in range(10):
            cell = f"ConvBnCell_{i}"
            cn = "conv2d" if i == 0 else f"conv2d_{i}"
            put(cn, [("kernel", p[cell]["Conv_0"]["kernel"]),
                     ("bias", p[cell]["Conv_0"]["bias"])])
            bn = "batch_normalization" if i == 0 \
                else f"batch_normalization_{i}"
            put(bn, [("gamma", p[cell]["BatchNorm_0"]["scale"]),
                     ("beta", p[cell]["BatchNorm_0"]["bias"]),
                     ("moving_mean", bs[cell]["BatchNorm_0"]["mean"]),
                     ("moving_variance", bs[cell]["BatchNorm_0"]["var"])])
        put("dense", [("kernel", p["Dense_0"]["kernel"]),
                      ("bias", p["Dense_0"]["bias"])])
        put("dense_1", [("kernel", p["Dense_1"]["kernel"]),
                        ("bias", p["Dense_1"]["bias"])])
        mw.attrs["layer_names"] = np.array([n.encode() for n in layer_names])
