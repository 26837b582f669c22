"""DL4J ModelSerializer zip interop (torch twin of
``gan_deeplearning4j_tpu/graph/dl4j_import.py``) — read (and write) the
reference's own model artifacts.

The only artifact the reference persists is a DL4J ``ModelSerializer`` zip:

  - ``configuration.json`` — the ``ComputationGraphConfiguration``
    (Jackson JSON: ``networkInputs`` / ``networkOutputs`` /
    ``vertexInputs`` / ``vertices`` with ``@class``-typed layer configs),
  - ``coefficients.bin`` — ALL parameters as ONE flattened row vector in
    topological order, serialized by ``Nd4j.write``: two DataBuffer
    records (shape-info, then data), each ``writeUTF(allocationMode)``,
    ``writeLong(length)``, ``writeUTF(dataType)``, big-endian elements
    (the 1.0.0-beta3 layout of the reference's classpath),
  - optionally ``updaterState.bin`` — the RmsProp accumulators as one flat
    ``Nd4j.write`` vector in coefficient order, except batch norm's
    mean/var (NoOp updater, no state elements).  Imported into the port's
    RmsProp state (torch tensors) when an RmsProp ``updater=`` is given,
    written back by ``export_dl4j(..., save_updater=True)``.

``import_dl4j`` reads such a zip into the port's ``ComputationGraph`` for
the layer types the reference uses (Dense, Output, Convolution
[Truncate], Subsampling[MAX], BatchNormalization, Upsampling2D, Dropout,
plus the FeedForwardToCnn / CnnToFeedForward preprocessors), on the card
unless the caller asks for another device.  Per-parameter layouts follow
DL4J's initializers: dense/output views are weights-first with
column-major (``'f'``) ``W``; convolution views are bias-FIRST with
row-major OIHW kernels; batch norm contributes ``[gamma, beta, mean,
var]``.  ``export_dl4j`` writes the same format.  The codec and the JSON
mapping are the JAX module's, written again here (the JAX package is not
imported): a zip written by either package imports into the other with
bitwise-equal parameters.  ``graph/serialization.py`` keeps its own
format.
"""

from __future__ import annotations

import io
import json
import struct
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gan_deeplearning4j_tpu_torch.graph.graph import (
    ComputationGraph,
    GraphBuilder,
    InputSpec,
)
from gan_deeplearning4j_tpu_torch.graph.layers import (
    BatchNorm,
    Conv2D,
    Dense,
    Dropout,
    MaxPool2D,
    Output,
    Upsampling2D,
)
from gan_deeplearning4j_tpu_torch.graph.preprocessors import FeedForwardToCnn
from gan_deeplearning4j_tpu_torch.optim.rmsprop import RmsProp

# -- ND4J binary DataBuffer / INDArray codec (Nd4j.write, beta3) ----------

_DTYPES = {"FLOAT": ("f", 4), "DOUBLE": ("d", 8),
           "INT": ("i", 4), "LONG": ("q", 8)}


def _write_utf(out: io.BufferedIOBase, s: str) -> None:
    data = s.encode("utf-8")  # Java modified-UTF8 == UTF-8 for ASCII
    out.write(struct.pack(">H", len(data)))
    out.write(data)


def _read_utf(src: io.BufferedIOBase) -> str:
    (n,) = struct.unpack(">H", src.read(2))
    return src.read(n).decode("utf-8")


def _write_buffer(out, values: np.ndarray, dtype: str) -> None:
    """One DataBuffer record: UTF allocation mode, long length, UTF
    data type, then big-endian elements (BaseDataBuffer.write)."""
    _write_utf(out, "MIXED_DATA_TYPES")  # beta3's allocation mode tag
    out.write(struct.pack(">q", values.size))
    _write_utf(out, dtype)
    code, _ = _DTYPES[dtype]
    out.write(np.ascontiguousarray(values).astype(f">{code}").tobytes())


def _read_buffer(src) -> np.ndarray:
    _read_utf(src)  # allocation mode: any token accepted, ignored
    (length,) = struct.unpack(">q", src.read(8))
    dtype = _read_utf(src)
    try:
        code, width = _DTYPES[dtype]
    except KeyError:
        raise ValueError(f"unsupported ND4J data type: {dtype!r}")
    raw = src.read(length * width)
    if len(raw) != length * width:
        raise ValueError("truncated ND4J data buffer")
    return np.frombuffer(raw, dtype=f">{code}").astype(code)


def write_nd4j(out, arr: np.ndarray) -> None:
    """``Nd4j.write``: shape-info buffer (LONG: rank, shape, c-order
    strides, extras=0, elementWiseStride=1, order char) then data."""
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    rank = arr.ndim
    strides = [int(np.prod(arr.shape[i + 1:], dtype=np.int64))
               for i in range(rank)]
    shape_info = np.asarray(
        [rank, *arr.shape, *strides, 0, 1, ord("c")], dtype=np.int64)
    _write_buffer(out, shape_info, "LONG")
    _write_buffer(out, arr, "FLOAT")


def read_nd4j(src) -> np.ndarray:
    shape_info = _read_buffer(src).astype(np.int64)
    rank = int(shape_info[0])
    shape = tuple(int(s) for s in shape_info[1:1 + rank])
    order = chr(int(shape_info[-1])) if shape_info[-1] in (99, 102) else "c"
    data = _read_buffer(src).astype(np.float32)
    if data.size != int(np.prod(shape, dtype=np.int64)):
        raise ValueError(
            f"ND4J data length {data.size} != shape product of {shape}")
    return data.reshape(shape, order=order.upper() if order == "f" else "C")


# -- layer config <-> JSON ------------------------------------------------

_NS = "org.deeplearning4j.nn.conf"
_ACT_NS = "org.nd4j.linalg.activations.impl.Activation"
_LOSS_NS = "org.nd4j.linalg.lossfunctions.impl.Loss"

# DL4J activation class simple-name suffix <-> ops.activations name
_ACT_FROM_DL4J = {
    "Identity": "identity", "TanH": "tanh", "Sigmoid": "sigmoid",
    "Softmax": "softmax", "ReLU": "relu", "LReLU": "leakyrelu",
    "ELU": "elu", "SELU": "selu", "SoftPlus": "softplus",
    "SoftSign": "softsign", "Cube": "cube",
    "RationalTanh": "rationaltanh", "HardTanH": "hardtanh",
    "HardSigmoid": "hardsigmoid", "Swish": "swish", "GELU": "gelu",
    "ReLU6": "relu6", "ThresholdedReLU": "thresholdedrelu",
}
_ACT_TO_DL4J = {v: k for k, v in _ACT_FROM_DL4J.items()}

_LOSS_FROM_DL4J = {
    "BinaryXENT": "xent", "MCXENT": "mcxent", "MSE": "mse",
    "L2": "l2", "L1": "l1",
    "NegativeLogLikelihood": "negativeloglikelihood",
    "Wasserstein": "wasserstein", "Hinge": "hinge",
}
_LOSS_TO_DL4J = {v: k for k, v in _LOSS_FROM_DL4J.items()}

# pre-1.0 "legacy" JSON wraps the layer in a lowercase type key instead
# of @class typing — tolerated on read
_LEGACY_LAYER_KEYS = {
    "dense": "DenseLayer", "output": "OutputLayer",
    "convolution": "ConvolutionLayer", "subsampling": "SubsamplingLayer",
    "batchNormalization": "BatchNormalization",
    "upsampling2d": "Upsampling2D",
}


def _simple_class(d, *, what: str) -> Tuple[str, dict]:
    """(simple class name, config dict) from an @class-typed (or legacy
    single-key-wrapped) JSON object."""
    if "@class" in d:
        return d["@class"].rsplit(".", 1)[-1].rsplit("$", 1)[-1], d
    if len(d) == 1:
        key, cfg = next(iter(d.items()))
        if key in _LEGACY_LAYER_KEYS and isinstance(cfg, dict):
            return _LEGACY_LAYER_KEYS[key], cfg
    raise ValueError(f"{what}: no @class type information in {list(d)[:6]}")


def _get(d: dict, *names, default=None, required=False):
    for n in names:
        if n in d:
            return d[n]
    if required:
        raise ValueError(f"missing field {names[0]!r} in {list(d)[:8]}")
    return default


def _act_name(cfg: dict) -> str:
    fn = _get(cfg, "activationFn", "activationFunction",
              default={"@class": _ACT_NS + "Identity"})
    if isinstance(fn, str):  # very old format: plain string name
        return fn.lower()
    simple = fn["@class"].rsplit(".", 1)[-1]
    suffix = simple[len("Activation"):] if simple.startswith(
        "Activation") else simple
    try:
        return _ACT_FROM_DL4J[suffix]
    except KeyError:
        raise NotImplementedError(f"unsupported DL4J activation: {simple}")


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1] if len(v) > 1 else v[0]))
    return (int(v), int(v))


# -- import ---------------------------------------------------------------

def _param_order(layer) -> List[Tuple[str, str]]:
    """Per-layer (param name, flatten order) in DL4J's parameter order —
    how the flat coefficients vector is segmented.  Dense/Output views
    are weights-FIRST, column-major ('F', WeightInitUtil's default
    order); convolution views are bias-FIRST with row-major OIHW kernels
    (ConvolutionParamInitializer carves bias at [0, nOut) and weights
    after — the reverse of DefaultParamInitializer's layout)."""
    if isinstance(layer, Conv2D):
        return [("b", "C"), ("W", "C")]
    if isinstance(layer, Dense):  # Output subclasses Dense
        return [("W", "F"), ("b", "C")]
    if isinstance(layer, BatchNorm):
        return [("gamma", "C"), ("beta", "C"), ("mean", "C"), ("var", "C")]
    return []


def _updater_state_order(layer) -> List[Tuple[str, str]]:
    """Per-layer (param, flatten order) segments of ``updaterState.bin``.
    Same parameter order as the coefficients vector, EXCEPT batch norm's
    running mean/var: DL4J assigns those a NoOp updater
    (``BatchNormalization.getUpdaterByParam`` — they are advanced by the
    forward pass's running average, not by gradients), and NoOp
    contributes zero state elements to the view."""
    if isinstance(layer, BatchNorm):
        return [("gamma", "C"), ("beta", "C")]
    return _param_order(layer)


def _parse_layer(simple: str, cfg: dict):
    """DL4J layer JSON -> (native layer, needs_n_in_fixup)."""
    if simple in ("DenseLayer", "OutputLayer"):
        kw = dict(
            n_out=int(_get(cfg, "nout", "nOut", required=True)),
            n_in=int(_get(cfg, "nin", "nIn", required=True)),
            activation=_act_name(cfg))
        if simple == "OutputLayer":
            fn = _get(cfg, "lossFn", "lossFunction", required=True)
            if isinstance(fn, str):
                lname = fn.lower().replace("_", "")
                loss = {"xent": "xent", "mcxent": "mcxent"}.get(lname, lname)
            else:
                lsimple = fn["@class"].rsplit(".", 1)[-1]
                suffix = (lsimple[len("Loss"):]
                          if lsimple.startswith("Loss") else lsimple)
                try:
                    loss = _LOSS_FROM_DL4J[suffix]
                except KeyError:
                    raise NotImplementedError(
                        f"unsupported DL4J loss: {lsimple}")
            return Output(loss=loss, **kw)
        return Dense(**kw)
    if simple == "ConvolutionLayer":
        mode = _get(cfg, "convolutionMode", default="Truncate")
        if mode not in (None, "Truncate"):
            raise NotImplementedError(
                f"convolutionMode={mode!r}; only Truncate (the reference's "
                "mode, with its output-size arithmetic) is implemented")
        return Conv2D(
            kernel=_pair(_get(cfg, "kernelSize", required=True)),
            stride=_pair(_get(cfg, "stride", default=(1, 1))),
            padding=_pair(_get(cfg, "padding", default=(0, 0))),
            n_out=int(_get(cfg, "nout", "nOut", required=True)),
            n_in=int(_get(cfg, "nin", "nIn", required=True)),
            activation=_act_name(cfg))
    if simple == "SubsamplingLayer":
        pooling = _get(cfg, "poolingType", default="MAX")
        if str(pooling).upper() != "MAX":
            raise NotImplementedError(
                f"poolingType={pooling!r}; only MAX (the reference's) "
                "is implemented")
        if _pair(_get(cfg, "padding", default=(0, 0))) != (0, 0):
            raise NotImplementedError("padded subsampling")
        return MaxPool2D(kernel=_pair(_get(cfg, "kernelSize", required=True)),
                         stride=_pair(_get(cfg, "stride", default=(1, 1))))
    if simple == "BatchNormalization":
        return BatchNorm(
            n=int(_get(cfg, "nout", "nOut", "nin", "nIn", required=True)),
            decay=float(_get(cfg, "decay", default=0.9)),
            eps=float(_get(cfg, "eps", default=1e-5)),
            activation=_act_name(cfg))
    if simple == "Upsampling2D":
        size = _pair(_get(cfg, "size", required=True))
        if size[0] != size[1]:
            raise NotImplementedError("non-square Upsampling2D")
        return Upsampling2D(size=size[0])
    if simple == "DropoutLayer":
        # DL4J's Dropout(p) carries the RETAIN probability; a null/absent
        # iDropout is the reference's `new DropoutLayer()` identity quirk
        idrop = _get(cfg, "idropout", "iDropout", default=None)
        if idrop is None:
            return Dropout(rate=0.0)
        p = float(_get(idrop, "p", "dropout", required=True))
        return Dropout(rate=1.0 - p)
    raise NotImplementedError(f"unsupported DL4J layer type: {simple}")


def _parse_preprocessor(d: Optional[dict]):
    if d is None:
        return None
    simple, cfg = _simple_class(d, what="preProcessor")
    if simple == "FeedForwardToCnnPreProcessor":
        return FeedForwardToCnn(
            height=int(_get(cfg, "inputHeight", "height", required=True)),
            width=int(_get(cfg, "inputWidth", "width", required=True)),
            channels=int(_get(cfg, "numChannels", "channels",
                              required=True)))
    if simple == "CnnToFeedForwardPreProcessor":
        # the graph flattens conv -> dense in the same (c, h, w) order
        # DL4J does, so there is nothing to attach
        return None
    raise NotImplementedError(f"unsupported preProcessor: {simple}")


def _parse_input_type(d: dict) -> InputSpec:
    simple, cfg = _simple_class(d, what="inputTypes")
    if simple == "InputTypeFeedForward":
        return InputSpec.feed_forward(int(_get(cfg, "size", required=True)))
    if simple == "InputTypeConvolutionalFlat":
        return InputSpec.convolutional_flat(
            int(_get(cfg, "height", required=True)),
            int(_get(cfg, "width", required=True)),
            int(_get(cfg, "depth", "channels", required=True)))
    if simple == "InputTypeConvolutional":
        return InputSpec.convolutional(
            int(_get(cfg, "channels", "depth", required=True)),
            int(_get(cfg, "height", required=True)),
            int(_get(cfg, "width", required=True)))
    raise NotImplementedError(f"unsupported input type: {simple}")


def _topo_order(inputs: List[str], vertex_inputs: Dict[str, List[str]]
                ) -> List[str]:
    """Topological order of vertices (DL4J flattens parameters in this
    order); deterministic for the linear chains the reference builds and
    for any DAG via Kahn's algorithm over the declared edges."""
    pending = {name: list(ins) for name, ins in vertex_inputs.items()}
    done = set(inputs)
    order: List[str] = []
    while pending:
        ready = [n for n, ins in pending.items()
                 if all(i in done for i in ins)]
        if not ready:
            raise ValueError(
                f"configuration has a cycle or dangling input: "
                f"{sorted(pending)[:4]}")
        for n in ready:
            order.append(n)
            done.add(n)
            del pending[n]
    return order


def import_dl4j(path: str, *, updater=None, seed: int = 666,
                load_updater: bool = True, device=None) -> ComputationGraph:
    """Read a DL4J ModelSerializer zip into a native ComputationGraph
    with identical inference behavior, on ``device`` (None = the card).
    ``updater``: optimizer for subsequent ``fit`` calls.  ``load_updater``: when the zip carries
    ``updaterState.bin`` (the reference saves with ``saveUpdater=true``,
    dl4jGANComputerVision.java:529-533) and ``updater`` is RmsProp, the
    saved accumulators are restored into ``opt_state`` so training
    CONTINUES from the artifact rather than restarting the optimizer —
    the ``ModelSerializer.restoreComputationGraph(file, loadUpdater)``
    semantic."""
    with zipfile.ZipFile(path) as zf:
        names = set(zf.namelist())
        if "configuration.json" not in names:
            raise ValueError(f"{path}: not a DL4J model zip "
                             f"(no configuration.json; has {sorted(names)})")
        conf = json.loads(zf.read("configuration.json"))
        flat = None
        if "coefficients.bin" in names:
            flat = read_nd4j(io.BytesIO(zf.read("coefficients.bin")))
            flat = np.asarray(flat, np.float32).ravel()
        state_flat = None
        if load_updater and updater is not None \
                and "updaterState.bin" in names:
            if not isinstance(updater, RmsProp):
                raise NotImplementedError(
                    "updaterState.bin import is implemented for RmsProp "
                    "(the only updater the reference persists); pass "
                    "load_updater=False to import weights only")
            state_flat = read_nd4j(io.BytesIO(zf.read("updaterState.bin")))
            state_flat = np.asarray(state_flat, np.float32).ravel()

    net_inputs = _get(conf, "networkInputs", required=True)
    net_outputs = _get(conf, "networkOutputs", required=True)
    vertex_inputs = _get(conf, "vertexInputs", required=True)
    vertices = _get(conf, "vertices", required=True)

    builder = GraphBuilder(seed=seed, activation="identity")
    builder.add_inputs(*net_inputs)
    input_types = _get(conf, "inputTypes", default=None)
    if input_types:
        builder.set_input_types(
            *[_parse_input_type(t) for t in input_types])

    order = _topo_order(list(net_inputs), vertex_inputs)
    parsed: List[Tuple[str, object]] = []
    for name in order:
        vertex = vertices[name]
        vsimple, vcfg = _simple_class(vertex, what=f"vertex {name}")
        if vsimple != "LayerVertex":
            raise NotImplementedError(
                f"unsupported vertex type: {vsimple} ({name})")
        layer_conf = _get(vcfg, "layerConf", required=True)
        layer_json = _get(layer_conf, "layer", required=True)
        lsimple, lcfg = _simple_class(layer_json, what=f"layer {name}")
        layer = _parse_layer(lsimple, lcfg)
        if updater is not None:
            layer.updater = updater
        builder.add_layer(name, layer, *vertex_inputs[name])
        pre = _parse_preprocessor(_get(vcfg, "preProcessor", default=None))
        if isinstance(pre, FeedForwardToCnn):
            builder.input_preprocessor(name, pre)
        parsed.append((name, layer))
    builder.set_outputs(*net_outputs)
    graph = builder.build(device).init()

    if flat is not None:
        off = 0
        for name, layer in parsed:
            for pname, forder in _param_order(layer):
                # the initialized graph's own shapes segment the vector
                # (nin/nout from the JSON determined them above)
                shape = tuple(graph.params[name][pname].shape)
                n = int(np.prod(shape, dtype=np.int64))
                if off + n > flat.size:
                    raise ValueError(
                        f"coefficients.bin too short at {name}.{pname}: "
                        f"need {off + n}, have {flat.size}")
                seg = flat[off:off + n].reshape(shape, order=forder)
                graph.set_layer_params(name, {pname: torch.from_numpy(
                    np.ascontiguousarray(seg)).to(graph.device)})
                off += n
        if off != flat.size:
            raise ValueError(
                f"coefficients.bin has {flat.size} values; configuration "
                f"accounts for {off}")

    if state_flat is not None:
        off = 0
        for name, layer in parsed:
            for pname, forder in _updater_state_order(layer):
                shape = tuple(graph.params[name][pname].shape)
                n = int(np.prod(shape, dtype=np.int64))
                if off + n > state_flat.size:
                    raise ValueError(
                        f"updaterState.bin too short at {name}.{pname}: "
                        f"need {off + n}, have {state_flat.size}")
                seg = state_flat[off:off + n].reshape(shape, order=forder)
                graph.opt_state[name][pname] = torch.from_numpy(
                    np.ascontiguousarray(seg)).to(graph.device)
                off += n
        if off != state_flat.size:
            raise ValueError(
                f"updaterState.bin has {state_flat.size} values; "
                f"configuration accounts for {off}")
    return graph


# -- export ---------------------------------------------------------------

def _host(t) -> np.ndarray:
    """A param or state leaf as a host f32 array."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def _layer_to_json(name: str, layer, params: Dict[str, np.ndarray]) -> dict:
    """The resolved native layer as beta3 layer JSON.  nIn/nOut come
    from the ACTUAL parameter shapes (a built graph may have inferred
    them; the dataclass fields can be None)."""

    def act(a):
        a = (a or "identity").lower()
        try:
            return {"@class": _ACT_NS + _ACT_TO_DL4J[a]}
        except KeyError:
            raise NotImplementedError(
                f"{name}: activation {a!r} has no DL4J class equivalent")

    base = {"layerName": name}
    if isinstance(layer, Conv2D):
        n_out, n_in = params["W"].shape[:2]
        return {
            "@class": f"{_NS}.layers.ConvolutionLayer", **base,
            "nin": int(n_in), "nout": int(n_out),
            "kernelSize": list(layer.kernel), "stride": list(layer.stride),
            "padding": list(layer.padding), "convolutionMode": "Truncate",
            "activationFn": act(layer.activation)}
    if isinstance(layer, Output):
        try:
            loss_cls = _LOSS_NS + _LOSS_TO_DL4J[layer.loss.lower()]
        except KeyError:
            raise NotImplementedError(
                f"{name}: loss {layer.loss!r} has no DL4J class equivalent")
        n_in, n_out = params["W"].shape
        return {"@class": f"{_NS}.layers.OutputLayer", **base,
                "nin": int(n_in), "nout": int(n_out),
                "lossFn": {"@class": loss_cls},
                "activationFn": act(layer.activation)}
    if isinstance(layer, Dense):
        n_in, n_out = params["W"].shape
        return {"@class": f"{_NS}.layers.DenseLayer", **base,
                "nin": int(n_in), "nout": int(n_out),
                "activationFn": act(layer.activation)}
    if isinstance(layer, BatchNorm):
        n = params["gamma"].shape[0]
        return {"@class": f"{_NS}.layers.BatchNormalization", **base,
                "nin": int(n), "nout": int(n),
                "decay": float(layer.decay), "eps": float(layer.eps),
                "activationFn": act(layer.activation)}
    if isinstance(layer, MaxPool2D):
        return {"@class": f"{_NS}.layers.SubsamplingLayer", **base,
                "poolingType": "MAX", "kernelSize": list(layer.kernel),
                "stride": list(layer.stride), "padding": [0, 0],
                "convolutionMode": "Truncate"}
    if isinstance(layer, Upsampling2D):
        return {"@class": f"{_NS}.layers.Upsampling2D", **base,
                "size": [int(layer.size), int(layer.size)]}
    if isinstance(layer, Dropout):
        out = {"@class": f"{_NS}.layers.DropoutLayer", **base}
        if layer.rate:
            out["idropout"] = {
                "@class": "org.nd4j.linalg.api.ops.random.impl.Dropout"
                          "Config",  # retain probability, DL4J convention
                "p": float(1.0 - layer.rate)}
        return out
    raise NotImplementedError(
        f"{name}: {type(layer).__name__} has no DL4J export mapping")


def _input_type_to_json(spec: InputSpec) -> dict:
    prefix = f"{_NS}.inputs.InputType$"
    if spec.kind == "ff":
        return {"@class": prefix + "InputTypeFeedForward",
                "size": int(spec.shape[0])}
    if spec.kind == "cnn_flat":
        h, w, c = spec.shape
        return {"@class": prefix + "InputTypeConvolutionalFlat",
                "height": int(h), "width": int(w), "depth": int(c)}
    c, h, w = spec.shape
    return {"@class": prefix + "InputTypeConvolutional",
            "channels": int(c), "height": int(h), "width": int(w)}


def export_dl4j(graph: ComputationGraph, path: str,
                save_updater: bool = True) -> None:
    """Write the graph as a DL4J ModelSerializer zip (beta3 layout) —
    the reverse migration path, and the fixture generator for the
    import parity tests.  ``save_updater``: also write
    ``updaterState.bin`` (RmsProp accumulators in DL4J's state-view
    layout) when the graph carries RmsProp-style optimizer state — the
    ``ModelSerializer.writeModel(model, path, true)`` semantic the
    reference uses (dl4jGANComputerVision.java:529-533).  Graphs with
    non-RmsProp state (Adam/Scheduled — DL4J's Adam view layout is
    per-updater-block, not implemented) degrade to a weights-only zip
    with a logged warning."""
    vertices, vertex_inputs = {}, {}
    segments: List[np.ndarray] = []
    state_segments: Optional[List[np.ndarray]] = []
    for name, node in graph.nodes.items():
        layer = node.layer
        params = {p: _host(v) for p, v in graph.params.get(name, {}).items()}
        if save_updater and getattr(graph, "opt_state", None) \
                and state_segments is not None:
            # the guard is by updater TYPE, not leaf shape: AdaGrad's
            # sum-of-squares leaf is shape-identical to an RmsProp cache
            # (a shape check would silently serialize wrong dynamics)
            # and Sgd's scalar leaf would corrupt the segmentation.
            # A missing per-layer updater is the frozen (_FROZEN RmsProp)
            # case — exportable zeros.
            up = getattr(getattr(graph, "updater", None),
                         "layer_updaters", {}).get(name)
            st = graph.opt_state.get(name, {})
            for pname, forder in _updater_state_order(layer):
                leaf = st.get(pname)
                if leaf is None:
                    continue
                if isinstance(leaf, dict) or (
                        up is not None and not isinstance(up, RmsProp)):
                    # Adam/Scheduled/Sgd/AdaGrad state has no DL4J
                    # RmsProp view equivalent: degrade to the
                    # weights-only zip (the pre-r5 behavior) rather
                    # than failing the export
                    import logging

                    logging.getLogger(__name__).warning(
                        "%s.%s carries non-RmsProp updater state; "
                        "updaterState.bin not written (weights-only "
                        "zip)", name, pname)
                    state_segments = None
                    break
                state_segments.append(_host(leaf).ravel(order=forder))
        vertex = {"@class": f"{_NS}.graph.LayerVertex",
                  "layerConf": {
                      "@class": f"{_NS}.NeuralNetConfiguration",
                      "layer": _layer_to_json(name, layer, params)}}
        pre = node.preprocessor
        if isinstance(pre, FeedForwardToCnn):
            vertex["preProcessor"] = {
                "@class": f"{_NS}.preprocessor.FeedForwardToCnnPreProcessor",
                "inputHeight": int(pre.height),
                "inputWidth": int(pre.width),
                "numChannels": int(pre.channels)}
        vertices[name] = vertex
        vertex_inputs[name] = list(node.inputs)
        for pname, forder in _param_order(layer):
            segments.append(params[pname].ravel(order=forder))

    conf = {
        "networkInputs": list(graph.input_names),
        "networkOutputs": list(graph.output_names),
        "vertexInputs": vertex_inputs,
        "vertices": vertices,
        "inputTypes": [_input_type_to_json(graph.input_specs[i])
                       for i in graph.input_names],
    }
    coeffs = io.BytesIO()
    if segments:
        flat = np.concatenate(segments).reshape(1, -1)
        write_nd4j(coeffs, flat)
    state = io.BytesIO()
    if state_segments:
        write_nd4j(state, np.concatenate(state_segments).reshape(1, -1))
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("configuration.json", json.dumps(conf, indent=2))
        if segments:
            zf.writestr("coefficients.bin", coeffs.getvalue())
        if state_segments:
            zf.writestr("updaterState.bin", state.getvalue())
