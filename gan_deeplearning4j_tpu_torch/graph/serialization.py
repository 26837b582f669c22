"""Model persistence, the DL4J ``ModelSerializer`` equivalent (torch twin
of ``gan_deeplearning4j_tpu/graph/serialization.py``, byte-compatible with
it in both directions; tests/test_torch_serialization.py pins the bytes).

A model zip holds ``config.json`` (topology, layer dataclasses with type
tags), ``params.npz`` and ``updater.npz`` (flat ``layer/param`` keys).
The file is the JAX package's, field for field: every layer dict carries
the JAX dataclass's fields in its order (``_FILE_FIELDS``; ``bf16_matmul``
as the layer holds it, null, true or false), so a zip written here is the
zip the JAX package writes for the same graph and state.  Member
timestamps are ``_ZIP_EPOCH``, the
``.npz`` members are stored, not deflated a second time, and arrays go
through ``np.lib.format.write_array`` as C-contiguous f32 host copies.
The updaters are the JAX package's set, RmsProp, Adam, Sgd, Nesterovs,
AdaGrad and ``Scheduled`` with the four schedule dataclasses, nested with
``__type__`` tags as the JAX package writes them.
"""

from __future__ import annotations

import dataclasses
import io
import json
import zipfile
from typing import Dict, Optional

import numpy as np
import torch

from gan_deeplearning4j_tpu_torch.graph import layers as L
from gan_deeplearning4j_tpu_torch.graph.graph import (
    ComputationGraph,
    GraphBuilder,
    InputSpec,
)
from gan_deeplearning4j_tpu_torch.graph.preprocessors import FeedForwardToCnn
from gan_deeplearning4j_tpu_torch.optim.adagrad import AdaGrad
from gan_deeplearning4j_tpu_torch.optim.adam import Adam
from gan_deeplearning4j_tpu_torch.optim.rmsprop import RmsProp
from gan_deeplearning4j_tpu_torch.optim.schedules import (
    ExponentialSchedule,
    PolySchedule,
    Scheduled,
    SigmoidSchedule,
    StepSchedule,
)
from gan_deeplearning4j_tpu_torch.optim.sgd import Nesterovs, Sgd

FORMAT_VERSION = 1

LAYER_TYPES = {cls.__name__: cls for cls in (
    L.Dense, L.Output, L.Conv2D, L.ConvTranspose2D, L.MaxPool2D,
    L.Upsampling2D, L.BatchNorm, L.Dropout, L.Merge, L.ElementWise,
    L.ConditionalBatchNorm, L.MinibatchStdDev, L.ProjectionOutput)}
PREPROCESSOR_TYPES = {"FeedForwardToCnn": FeedForwardToCnn}

# The JAX layer dataclasses' fields, in their order.
_BASE = ("activation", "updater", "weight_init")
_FILE_FIELDS = {
    "Dense": _BASE + ("n_out", "n_in", "bf16_matmul"),
    "Output": _BASE + ("n_out", "n_in", "bf16_matmul", "loss"),
    "Conv2D": _BASE + ("kernel", "stride", "padding", "n_in", "n_out",
                       "bf16_matmul"),
    "ConvTranspose2D": _BASE + ("kernel", "stride", "padding", "n_in",
                                "n_out", "bf16_matmul"),
    "MaxPool2D": _BASE + ("kernel", "stride"),
    "Upsampling2D": _BASE + ("size",),
    "BatchNorm": _BASE + ("n", "decay", "eps"),
    "Dropout": _BASE + ("rate",),
    "Merge": _BASE,
    "ElementWise": _BASE + ("op",),
    "ConditionalBatchNorm": _BASE + ("num_classes", "n", "decay", "eps"),
    "MinibatchStdDev": _BASE + ("group_size", "eps"),
    "ProjectionOutput": _BASE + ("n_in", "num_classes", "loss"),
}

# updater and schedule kinds by type tag (a config without a tag is
# RmsProp); ``Scheduled`` nests a base updater and a schedule
_UPDATER_TYPES = {cls.__name__: cls for cls in (
    RmsProp, Adam, Sgd, Nesterovs, AdaGrad, Scheduled, StepSchedule,
    ExponentialSchedule, PolySchedule, SigmoidSchedule)}


def _updater_to_dict(u) -> dict:
    """A dataclass updater or schedule as the JAX package writes it: the
    type tag first, then the fields, a dataclass field nested."""
    if _UPDATER_TYPES.get(type(u).__name__) is not type(u):
        raise TypeError(f"cannot serialize updater/schedule {type(u)!r}")
    d = {"__type__": type(u).__name__}
    for f in dataclasses.fields(u):
        v = getattr(u, f.name)
        d[f.name] = _updater_to_dict(v) if dataclasses.is_dataclass(v) else v
    return d


def _updater_from_dict(d: dict):
    d = dict(d)
    kind = d.pop("__type__", "RmsProp")
    if kind not in _UPDATER_TYPES:
        raise ValueError(f"unknown updater or schedule {kind!r}; known: "
                         f"{sorted(_UPDATER_TYPES)}")
    return _UPDATER_TYPES[kind](**{
        k: (_updater_from_dict(v) if isinstance(v, dict) and "__type__" in v
            else v)
        for k, v in d.items()})


def _jsonable(v):
    return list(v) if isinstance(v, tuple) else v


def _layer_to_dict(layer) -> dict:
    kind = type(layer).__name__
    d = {name: _jsonable(getattr(layer, name, None))
         for name in _FILE_FIELDS[kind]}
    if d["updater"] is not None:
        d["updater"] = _updater_to_dict(layer.updater)
    d["__type__"] = kind
    return d


def _layer_from_dict(d: dict):
    d = dict(d)
    kind = d.pop("__type__")
    if kind not in LAYER_TYPES:
        raise NotImplementedError(f"layer type {kind!r} is not ported yet")
    cls = LAYER_TYPES[kind]
    own = {f.name for f in dataclasses.fields(cls)}
    for name in set(d) - own:
        if d.pop(name) is not None:
            raise NotImplementedError(
                f"{kind}.{name} is set; the port has no {name}")
    if d.get("updater") is not None:
        d["updater"] = _updater_from_dict(d["updater"])
    return cls(**d)


def _preproc_to_dict(p) -> dict:
    return {**dataclasses.asdict(p), "__type__": type(p).__name__}


def _preproc_from_dict(d: dict):
    d = dict(d)
    kind = d.pop("__type__")
    if kind not in PREPROCESSOR_TYPES:
        raise NotImplementedError(f"preprocessor {kind!r} is not ported yet")
    return PREPROCESSOR_TYPES[kind](**d)


def graph_config_to_dict(graph: ComputationGraph) -> dict:
    return {
        "format_version": FORMAT_VERSION,
        "seed": graph.seed,
        "l2": graph.l2,
        "clip_threshold": graph.clip_threshold,
        "frozen": sorted(graph.frozen),
        "inputs": graph.input_names,
        "input_specs": {
            k: {"kind": v.kind, "shape": list(v.shape)}
            for k, v in graph.input_specs.items()
        },
        "outputs": graph.output_names,
        "nodes": [
            {
                "name": name,
                "layer": _layer_to_dict(node.layer),
                "inputs": list(node.inputs),
                "preprocessor": (_preproc_to_dict(node.preprocessor)
                                 if node.preprocessor is not None else None),
            }
            for name, node in graph.nodes.items()
        ],
    }


def graph_from_config_dict(cfg: dict, device=None) -> ComputationGraph:
    """The graph of ``cfg`` on ``device`` (None = the card), without
    params."""
    builder = GraphBuilder(seed=cfg["seed"], l2=cfg["l2"],
                           clip_threshold=cfg["clip_threshold"])
    builder.add_inputs(*cfg["inputs"])
    builder.set_input_types(*[
        InputSpec(cfg["input_specs"][i]["kind"],
                  tuple(cfg["input_specs"][i]["shape"]))
        for i in cfg["inputs"]])
    for nd in cfg["nodes"]:
        builder.add_layer(nd["name"], _layer_from_dict(nd["layer"]),
                          *nd["inputs"])
        if nd["preprocessor"] is not None:
            builder.input_preprocessor(nd["name"],
                                       _preproc_from_dict(nd["preprocessor"]))
    builder.set_outputs(*cfg["outputs"])
    graph = builder.build(device)
    graph.frozen = frozenset(cfg["frozen"])
    graph.updater.layer_updaters = {
        name: node.layer.updater for name, node in graph.nodes.items()
        if node.layer.has_params and name not in graph.frozen}
    return graph


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts -> '/'-joined flat keys of C-contiguous host arrays."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            # np.require, not np.ascontiguousarray: that makes a 0-d
            # array (Adam's step count) 1-d
            out[key] = np.require(
                v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v), requirements="C")
    return out


def _unflatten(flat, device) -> Dict:
    """Inverse of ``_flatten`` onto ``device``, any depth (Adam's state is
    {layer: {param: {m, v, t}}}), each array's dtype kept; accepts an
    ``np.load`` handle (``.files``) or a plain {key: array} mapping."""
    tree: Dict = {}
    for key in (flat.files if hasattr(flat, "files") else flat):
        parts = key.split("/")
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = torch.from_numpy(np.array(flat[key])).to(device)
    return tree


# Fixed zip member timestamp: equal state gives equal bytes.
_ZIP_EPOCH = (1980, 1, 1, 0, 0, 0)


def _zip_writestr(zf: zipfile.ZipFile, name: str, data,
                  compress_type: Optional[int] = None) -> None:
    info = zipfile.ZipInfo(name, date_time=_ZIP_EPOCH)
    info.compress_type = (zf.compression if compress_type is None
                          else compress_type)
    info.external_attr = 0o600 << 16
    zf.writestr(info, data)


def npz_bytes(flat: Dict[str, np.ndarray]) -> bytes:
    """Deterministic ``.npz`` bytes for a flat {key: array} mapping."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for key, arr in flat.items():
            member = io.BytesIO()
            np.lib.format.write_array(member, np.asarray(arr),
                                      allow_pickle=False)
            _zip_writestr(zf, key + ".npy", member.getvalue())
    return buf.getvalue()


def model_zip_bytes(config: dict, flat_params: Dict[str, np.ndarray],
                    flat_updater: Optional[Dict[str, np.ndarray]]) -> bytes:
    """The model-zip format from already-flattened host arrays (no graph
    access, no device contact: a background writer can run it)."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        _zip_writestr(zf, "config.json", json.dumps(config, indent=1))
        # the .npz members are already deflated: store them raw
        _zip_writestr(zf, "params.npz", npz_bytes(flat_params),
                      compress_type=zipfile.ZIP_STORED)
        if flat_updater is not None:
            _zip_writestr(zf, "updater.npz", npz_bytes(flat_updater),
                          compress_type=zipfile.ZIP_STORED)
    return buf.getvalue()


def snapshot_model_parts(graph: ComputationGraph, save_updater: bool = True):
    """(config_dict, flat_params, flat_updater_or_None) as host copies."""
    flat_updater = _flatten(graph.opt_state) if save_updater else None
    return graph_config_to_dict(graph), _flatten(graph.params), flat_updater


def write_model(graph: ComputationGraph, path: str,
                save_updater: bool = True) -> None:
    with open(path, "wb") as f:
        f.write(model_zip_bytes(*snapshot_model_parts(graph, save_updater)))


def read_model(path: str, device=None) -> ComputationGraph:
    """The graph of a model zip with its params (and updater state: a zip
    without ``updater.npz`` gets a fresh one) on ``device``
    (None = the card)."""
    with zipfile.ZipFile(path) as zf:
        graph = graph_from_config_dict(json.loads(zf.read("config.json")),
                                       device)
        dev = graph.device
        params = _unflatten(np.load(io.BytesIO(zf.read("params.npz"))), dev)
        for name in graph.nodes:  # layers with no params: empty slots
            params.setdefault(name, {})
        graph.params = params
        if "updater.npz" in zf.namelist():
            opt = _unflatten(np.load(io.BytesIO(zf.read("updater.npz"))), dev)
            for name in graph.nodes:
                opt.setdefault(name, {})
            graph.opt_state = opt
        else:
            graph.opt_state = graph.updater.init(graph.params)
    return graph
