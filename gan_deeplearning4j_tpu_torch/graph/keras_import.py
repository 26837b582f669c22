"""Keras model import (torch twin of ``gan_deeplearning4j_tpu/graph/
keras_import.py``) — the ``deeplearning4j-modelimport`` equivalent.

Like DL4J's ``KerasModelImport.importKerasSequentialModelAndWeights``, it
turns a Keras model into the port's ``ComputationGraph`` with the weights
copied over.  The layer set is the JAX module's: Sequential and
functional models of Dense / Conv2D / Conv2DTranspose / BatchNormalization
/ Dropout / MaxPooling2D / UpSampling2D / Flatten / Reshape / Activation /
InputLayer, plus Concatenate (``Merge``) and Add / Average / Maximum /
Subtract (``ElementWise``).  channels_last Keras convs convert to the
NCHW layout:

  - Conv kernels ``[kh, kw, in, out]`` -> ``[out, in, kh, kw]``.
  - The Dense layer that follows a Flatten has its kernel's input axis
    re-ordered from Keras's ``(h, w, c)`` flatten order to the NCHW
    ``(c, h, w)`` order this package flattens in.
  - An imported graph therefore takes NCHW input; use
    ``x.permute(0, 3, 1, 2)`` on channels_last batches.

A live model is read duck-typed (``model.layers``, ``get_config()``,
``get_weights()``, ``_keras_history``), with no import of keras.  Keras is
imported lazily, in ``_load`` only, to load a model FILE; it is not a
dependency of this package (and importing it loads a backend of its own).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gan_deeplearning4j_tpu_torch.graph.graph import GraphBuilder, InputSpec
from gan_deeplearning4j_tpu_torch.graph.layers import (
    BatchNorm,
    Conv2D,
    ConvTranspose2D,
    Dense,
    Dropout,
    ElementWise,
    MaxPool2D,
    Merge,
    Upsampling2D,
)
from gan_deeplearning4j_tpu_torch.graph.preprocessors import FeedForwardToCnn

# Keras activation identifier -> ops.activations name.  Only mappings
# whose DEFINITIONS match exactly are listed: Keras 'leaky_relu' (slope
# 0.2 vs DL4J's 0.01), 'hard_sigmoid' (relu6(x+3)/6 vs clip(0.2x+0.5))
# and 'gelu' (exact vs tanh-approximate) differ and must raise, not
# silently approximate.
_ACT = {
    "linear": "identity",
    "relu": "relu",
    "tanh": "tanh",
    "sigmoid": "sigmoid",
    "softmax": "softmax",
    "elu": "elu",
    "selu": "selu",
    "swish": "swish",
    "silu": "swish",
    "softplus": "softplus",
    "softsign": "softsign",
}


def _act_name(keras_act) -> str:
    name = getattr(keras_act, "__name__", None) or str(keras_act)
    try:
        mapped = _ACT[name]
    except KeyError:
        raise NotImplementedError(f"unsupported Keras activation: {name!r}")
    return mapped


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (int(v), int(v))


def _layer_inputs(kl) -> list:
    """A layer's input tensors as a list (Keras returns a bare tensor
    for single-input layers)."""
    try:
        k_in = kl.input
    except Exception as e:
        raise NotImplementedError(
            f"layer {kl.name}: cannot resolve inputs (layer reused at "
            "multiple call sites?)") from e
    return list(k_in) if isinstance(k_in, (list, tuple)) else [k_in]


def _kernel_bias(kl, cfg, bias_axis: int = -1):
    """(kernel, bias) with a zeros bias when ``use_bias=False``.
    ``bias_axis`` names the kernel axis holding the output count: the
    last for Dense ``(in, out)`` and Conv2D hwio ``(h, w, in, out)``,
    axis 2 for Conv2DTranspose's reversed ``(h, w, out, in)``."""
    weights = kl.get_weights()
    kernel = np.asarray(weights[0])
    if cfg.get("use_bias", True):
        return kernel, np.asarray(weights[1])
    return kernel, np.zeros(kernel.shape[bias_axis], np.float32)


def _same_padding(kernel, stride, what):
    """Keras 'same' -> symmetric explicit padding; only the symmetric
    cases (odd kernel, stride 1) translate exactly."""
    kh, kw = kernel
    if stride != (1, 1) or kh % 2 == 0 or kw % 2 == 0:
        raise NotImplementedError(
            f"{what}: padding='same' with stride {stride} / kernel "
            f"{kernel} pads asymmetrically in Keras; import supports "
            "'valid', or 'same' with stride 1 and odd kernels")
    return (kh // 2, kw // 2)


def _load(path_or_model):
    """A live model as it is (read duck-typed: ``layers``, ``inputs``,
    ``outputs``), or the file loaded by keras, imported here and only
    here."""
    if all(hasattr(path_or_model, a) for a in ("layers", "inputs",
                                                 "outputs")):
        return path_or_model
    try:
        import keras
    except ImportError as e:
        raise ImportError(
            "loading a Keras model file needs the 'keras' package (with "
            "h5py for .h5 files); it is not a dependency of this package "
            "— pass a live model instead") from e
    return keras.models.load_model(path_or_model, compile=False)


def import_keras(path_or_model, *, updater=None, seed: int = 666,
                 name_prefix: str = "", device=None):
    """Import a saved Keras model (``.h5`` or ``.keras``; or a live
    ``keras.Model``) as a ``ComputationGraph`` on ``device`` (None = the
    card) with identical inference behavior (channels-last convs re-laid
    to NCHW).

    ``updater``: optimizer for subsequent ``fit`` calls (imported graphs
    are inference-exact; training config is NOT imported, as with DL4J's
    ``enforceTrainingConfig=False``).
    """
    model = _load(path_or_model)

    builder = GraphBuilder(seed=seed, activation="identity")

    layers = [l for l in model.layers
              if l.__class__.__name__ != "InputLayer"]

    # -- model inputs (functional models may have several) ---------------
    def _producer(tensor):
        hist = getattr(tensor, "_keras_history", None)
        op = getattr(hist, "operation", None) if hist else None
        if op is None:
            raise NotImplementedError(
                "tensor without keras history — unsupported model graph")
        return op

    input_ops, input_specs, input_names = [], [], []
    for i, t in enumerate(model.inputs):
        op = _producer(t)
        in_shape = tuple(t.shape)[1:]
        if len(in_shape) == 3:
            h, w, c = in_shape
            input_specs.append(InputSpec.convolutional(c, h, w))
        elif len(in_shape) == 1:
            input_specs.append(InputSpec.feed_forward(in_shape[0]))
        else:
            raise NotImplementedError(f"unsupported input rank: {in_shape}")
        iname = name_prefix + (op.name if len(model.inputs) > 1 else "in")
        input_ops.append(op)
        input_names.append(iname)
    builder.add_inputs(*input_names)
    builder.set_input_types(*input_specs)

    # -- DAG bookkeeping --------------------------------------------------
    # keras operation (layer / InputLayer) id -> graph node name holding
    # its output.  Virtual ops (Flatten/Reshape/Activation) alias their
    # producer's node; their effect is recorded in the side tables below.
    op_node = {id(op): nm for op, nm in zip(input_ops, input_names)}
    weight_ops = []      # (node_name, {param: ndarray}) applied after init
    by_node = {}         # node name -> weight dict (for the Reshape fixup)
    flatten_from = {}    # keras op id -> (h, w, c) a Flatten recorded
    preproc_from = {}    # keras op id -> FeedForwardToCnn a Reshape recorded
    nodes = {}           # node name -> our layer object

    # consumer counts gate Activation folding and the Reshape/Flatten
    # aliases: mutating a producer consumed elsewhere too would corrupt
    # the other branch
    n_consumers = {}
    for kl in layers:
        for t in _layer_inputs(kl):
            n_consumers[id(_producer(t))] = n_consumers.get(
                id(_producer(t)), 0) + 1
    for t in model.outputs:
        n_consumers[id(_producer(t))] = n_consumers.get(
            id(_producer(t)), 0) + 1

    def fresh(name):
        n = name_prefix + name
        return n if n not in nodes and n not in input_names \
            else f"{n}_{len(nodes)}"

    def node_of(kl, what):
        try:
            return op_node[id(kl)]
        except KeyError:
            raise NotImplementedError(
                f"{what}: input produced by an unprocessed or unsupported "
                f"layer {getattr(kl, 'name', kl)!r} — layers must arrive "
                "in topological order") from None

    for kl in layers:
        kind = kl.__class__.__name__
        cfg = kl.get_config()
        producers = [_producer(t) for t in _layer_inputs(kl)]

        if kind in ("Concatenate", "Add", "Average", "Maximum", "Subtract"):
            in_nodes = [node_of(p, kl.name) for p in producers]
            for p in producers:
                if id(p) in flatten_from or id(p) in preproc_from:
                    raise NotImplementedError(
                        f"{kl.name}: merge of a Flatten/Reshape output is "
                        "not supported")
            if kind == "Concatenate":
                axis = cfg.get("axis", -1)
                ranks = {len(tuple(t.shape)) for t in _layer_inputs(kl)}
                if ranks == {2} and axis not in (-1, 1):
                    raise NotImplementedError(
                        f"{kl.name}: Concatenate axis {axis} on 2-D input")
                if ranks == {4} and axis not in (-1, 3):
                    # channels_last channel concat -> our NCHW axis 1
                    raise NotImplementedError(
                        f"{kl.name}: Concatenate axis {axis} on 4-D input")
                layer = Merge()
            else:
                layer = ElementWise(op={"Add": "add", "Average": "average",
                                        "Maximum": "max",
                                        "Subtract": "subtract"}[kind])
            name = fresh(kl.name)
            builder.add_layer(name, layer, *in_nodes)
            nodes[name] = layer
            op_node[id(kl)] = name
            continue

        if len(producers) != 1:
            raise NotImplementedError(
                f"layer {kl.name}: multi-input {kind} is not supported")
        producer = producers[0]
        prev = node_of(producer, kl.name)

        if kind == "Flatten":
            if id(producer) in flatten_from or id(producer) in preproc_from:
                raise NotImplementedError(
                    f"{kl.name}: Flatten after Flatten/Reshape")
            shape = tuple(_layer_inputs(kl)[0].shape)[1:]
            op_node[id(kl)] = prev  # alias: the fixup happens at the Dense
            if len(shape) == 3:
                flatten_from[id(kl)] = shape
            continue
        if kind == "Reshape":
            # the DCGAN-generator seam: Dense -> Reshape((h, w, c)) ->
            # conv stack.  This framework's FeedForwardToCnn interprets
            # the flat vector in (c, h, w) order, so permute the
            # PRODUCING Dense's output columns (and bias) from Keras's
            # (h, w, c) order — the Flatten fixup in reverse.
            tgt = tuple(cfg["target_shape"])
            if len(tgt) != 3:
                raise NotImplementedError(
                    f"{kl.name}: Reshape to non-(h, w, c) {tgt}")
            h, w, c = tgt
            if (id(producer) in flatten_from or id(producer) in preproc_from
                    or not isinstance(nodes.get(prev), Dense)
                    or n_consumers.get(id(producer), 0) > 1):
                raise NotImplementedError(
                    f"{kl.name}: Reshape must directly follow a Dense "
                    "layer with no other consumers (the supported "
                    "generator seam)")
            wd = by_node[prev]
            kern, bias = wd["W"], wd["b"]
            if kern.shape[1] != h * w * c:
                raise ValueError(
                    f"{kl.name}: Reshape target {tgt} does not match the "
                    f"preceding Dense width {kern.shape[1]}")
            wd["W"] = (kern.reshape(-1, h, w, c).transpose(0, 3, 1, 2)
                       .reshape(kern.shape[0], h * w * c))
            wd["b"] = bias.reshape(h, w, c).transpose(2, 0, 1).ravel()
            op_node[id(kl)] = prev
            preproc_from[id(kl)] = FeedForwardToCnn(h, w, c)
            continue
        if kind == "Activation":
            act = _act_name(cfg["activation"])
            target = nodes.get(prev)
            # fold ONLY onto layers whose apply() runs self._act —
            # pool/dropout/upsample ignore .activation entirely, so
            # folding there would silently drop the nonlinearity; a
            # producer with other consumers would leak the activation
            # into their branch
            if (not isinstance(target, (Dense, Conv2D, BatchNorm))
                    or target.activation not in (None, "identity")
                    or n_consumers.get(id(producer), 0) > 1):
                raise NotImplementedError(
                    "standalone Activation layer must directly follow a "
                    "linear Dense/Conv2D/BatchNormalization layer with no "
                    "other consumers")
            target.activation = act
            op_node[id(kl)] = prev
            continue

        consumed_flatten = flatten_from.get(id(producer))
        pending_preproc = preproc_from.get(id(producer))
        name = fresh(kl.name)
        if kind == "Dense":
            kernel, bias = _kernel_bias(kl, cfg)
            if consumed_flatten is not None:
                fh, fw, fc = consumed_flatten
                # Keras flattened (h, w, c); this framework flattens (c, h, w)
                kernel = (kernel.reshape(fh, fw, fc, -1)
                          .transpose(2, 0, 1, 3)
                          .reshape(fh * fw * fc, -1))
            layer = Dense(n_out=cfg["units"],
                          activation=_act_name(cfg["activation"]),
                          updater=updater)
            weight_ops.append((name, {"W": kernel, "b": bias}))
        elif kind == "Conv2D":
            if cfg.get("data_format") not in (None, "channels_last"):
                raise NotImplementedError("channels_first Keras convs")
            if _pair(cfg.get("dilation_rate", 1)) != (1, 1):
                raise NotImplementedError("dilated Keras convs")
            if cfg.get("groups", 1) != 1:
                raise NotImplementedError("grouped Keras convs")
            kernel = _pair(cfg["kernel_size"])
            stride = _pair(cfg["strides"])
            pad = ((0, 0) if cfg["padding"] == "valid"
                   else _same_padding(kernel, stride, kl.name))
            w, b = _kernel_bias(kl, cfg)
            w = w.transpose(3, 2, 0, 1)  # hwio -> oihw
            layer = Conv2D(kernel=kernel, stride=stride, padding=pad,
                           n_out=cfg["filters"],
                           activation=_act_name(cfg["activation"]),
                           updater=updater)
            weight_ops.append((name, {"W": w, "b": b}))
        elif kind == "Conv2DTranspose":
            # the DCGAN-generator layer.  Kernel layout is [kh, kw, OUT,
            # IN] (note: reversed vs Conv2D's [kh, kw, in, out]); Keras
            # 'same' upsamples to exactly h*s, which equals this
            # framework's (h-1)s - 2p + k at p = (k-s)/2 — exact only
            # when k-s is even (parity-tested vs Keras at ulp level).
            if cfg.get("data_format") not in (None, "channels_last"):
                raise NotImplementedError("channels_first Keras convs")
            if _pair(cfg.get("dilation_rate", 1)) != (1, 1):
                raise NotImplementedError("dilated transposed convs")
            if cfg.get("output_padding") not in (None, 0, (0, 0), [0, 0]):
                raise NotImplementedError("explicit output_padding")
            kernel = _pair(cfg["kernel_size"])
            stride = _pair(cfg["strides"])
            kh, kw_ = kernel
            sh, sw = stride
            if kh < sh or kw_ < sw:
                # k < s breaks both translations: 'same' would need
                # negative padding, 'valid' Keras output is in*s +
                # max(k-s, 0) vs this framework's (in-1)s + k
                raise NotImplementedError(
                    f"{kl.name}: Conv2DTranspose kernel {kernel} smaller "
                    f"than stride {stride}")
            if cfg["padding"] == "valid":
                pad = (0, 0)
            else:
                if (kh - sh) % 2 or (kw_ - sw) % 2:
                    raise NotImplementedError(
                        f"{kl.name}: Conv2DTranspose padding='same' with "
                        f"odd kernel-stride difference {kernel}/{stride} "
                        "pads asymmetrically in Keras")
                pad = ((kh - sh) // 2, (kw_ - sw) // 2)
            w, b = _kernel_bias(kl, cfg, bias_axis=2)  # [kh, kw, OUT, in]
            w = w.transpose(2, 3, 0, 1)  # hw-out-in -> [O, I, kh, kw]
            layer = ConvTranspose2D(kernel=kernel, stride=stride,
                                    padding=pad, n_out=cfg["filters"],
                                    activation=_act_name(cfg["activation"]),
                                    updater=updater)
            weight_ops.append((name, {"W": w, "b": b}))
        elif kind == "BatchNormalization":
            axis = cfg.get("axis", -1)
            axis = axis[0] if isinstance(axis, (list, tuple)) else axis
            if len(kl.output.shape) == 4 and axis not in (-1, 3):
                raise NotImplementedError("BatchNorm over a non-channel axis")
            weights = [np.asarray(a) for a in kl.get_weights()]
            # center/scale=False drop beta/gamma from get_weights();
            # synthesize the identity values (zeros beta, ones gamma) so
            # inference stays exact instead of mis-unpacking.
            it = iter(weights)
            g = next(it) if cfg.get("scale", True) else None
            b = next(it) if cfg.get("center", True) else None
            m, v = next(it), next(it)
            if g is None:
                g = np.ones_like(m)
            if b is None:
                b = np.zeros_like(m)
            layer = BatchNorm(decay=cfg["momentum"], eps=cfg["epsilon"],
                              updater=updater)
            weight_ops.append(
                (name, {"gamma": g, "beta": b, "mean": m, "var": v}))
        elif kind == "Dropout":
            layer = Dropout(rate=cfg["rate"])
        elif kind == "MaxPooling2D":
            if cfg["padding"] != "valid":
                raise NotImplementedError("MaxPooling2D padding='same'")
            layer = MaxPool2D(kernel=_pair(cfg["pool_size"]),
                              stride=_pair(cfg["strides"] or cfg["pool_size"]))
        elif kind == "UpSampling2D":
            size = _pair(cfg["size"])
            if size[0] != size[1]:
                raise NotImplementedError("non-square UpSampling2D")
            if cfg.get("interpolation", "nearest") != "nearest":
                # this framework's Upsampling2D is nearest-neighbor only;
                # importing a bilinear config would silently change
                # inference outputs (maxdiff ~0.37 measured), breaking
                # the module's inference-exactness contract.
                raise NotImplementedError(
                    f"{kl.name}: UpSampling2D interpolation="
                    f"{cfg['interpolation']!r}; only 'nearest' is exact")
            layer = Upsampling2D(size=size[0])
        else:
            raise NotImplementedError(
                f"unsupported Keras layer type: {kind} ({kl.name})")

        if consumed_flatten is not None and kind != "Dense":
            raise NotImplementedError(
                f"{kl.name}: only Dense may consume a Flatten output")
        builder.add_layer(name, layer, prev)
        if pending_preproc is not None:
            builder.input_preprocessor(name, pending_preproc)
        nodes[name] = layer
        op_node[id(kl)] = name
        if weight_ops and weight_ops[-1][0] == name:
            by_node[name] = weight_ops[-1][1]

    out_nodes = []
    for t in model.outputs:
        op = _producer(t)
        if id(op) in preproc_from or id(op) in flatten_from:
            raise NotImplementedError(
                "model ends on a Reshape/Flatten with no consumer")
        out_nodes.append(node_of(op, "model output"))
    builder.set_outputs(*out_nodes)
    graph = builder.build(device).init()
    for name, values in weight_ops:
        for pname, value in values.items():
            expect = graph.params[name][pname].shape
            if tuple(value.shape) != tuple(expect):
                raise ValueError(
                    f"{name}.{pname}: keras weight shape {value.shape} "
                    f"!= graph shape {expect}")
            graph.set_layer_params(name, {pname: torch.from_numpy(
                np.ascontiguousarray(value, np.float32)).to(graph.device)})
    return graph
