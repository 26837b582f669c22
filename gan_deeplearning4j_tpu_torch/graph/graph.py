"""Named-layer computation graph (torch twin of ``gan_deeplearning4j_tpu/
graph/graph.py``).

Parameters are a plain ``{layer: {param: tensor}}`` tree on the graph's
device, and every step is functional: ``_train_step`` takes params and
updater state and returns new ones without touching its inputs (``fit``
runs it on the graph's own state).  So the protocol's cross-graph weight
syncs are dict assignments that alias tensors, as they are pytree merges
in the JAX package.  DL4J's listener surface (``set_listeners``,
``add_listeners``; ``utils/listeners.py``) fires after each eager ``fit``
with the step's loss as a device scalar; ``score_on`` is DL4J's
``score(DataSet)``, the inference-mode loss.

Under the ``--mp`` policy (``backend.configure(compute_bf16=True)``) the
forward casts, with explicit casts where the JAX package puts them (not
``torch.autocast``, whose per-op lists round elsewhere): every f32 input,
every non-BN layer's params and every f32 layer output to bf16; the
BatchNorm and ConditionalBatchNorm layers keep f32 params and get their
(first) input upcast to f32, so batch statistics, running-stat EMAs and
the BN kernels never see bf16.  Gradients flow through the casts back to
the f32 master params; the loss is taken on f32 head outputs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from gan_deeplearning4j_tpu_torch.graph.layers import (
    BatchNorm,
    ConditionalBatchNorm,
    Layer,
)
from gan_deeplearning4j_tpu_torch.ops import losses as loss_lib
from gan_deeplearning4j_tpu_torch.optim.rmsprop import RmsProp
from gan_deeplearning4j_tpu_torch.optim.updater import GraphUpdater
from gan_deeplearning4j_tpu_torch.parallel import mesh
from gan_deeplearning4j_tpu_torch.runtime import backend, prng
from gan_deeplearning4j_tpu_torch.telemetry import ingraph

Tree = Dict[str, Dict[str, torch.Tensor]]


def _down(t: torch.Tensor) -> torch.Tensor:
    """The ``--mp`` cast: f32 to bf16, any other dtype as it is."""
    return t.to(torch.bfloat16) if t.dtype == torch.float32 else t


@dataclasses.dataclass(frozen=True)
class InputSpec:
    """DL4J InputType equivalent."""

    kind: str  # 'ff' | 'cnn_flat' | 'cnn'
    shape: Tuple[int, ...]

    @staticmethod
    def feed_forward(n: int) -> "InputSpec":
        return InputSpec("ff", (n,))

    @staticmethod
    def convolutional_flat(height: int, width: int, channels: int) -> "InputSpec":
        return InputSpec("cnn_flat", (height, width, channels))

    @staticmethod
    def convolutional(channels: int, height: int, width: int) -> "InputSpec":
        return InputSpec("cnn", (channels, height, width))

    def node_shape(self) -> Tuple[int, ...]:
        if self.kind == "cnn_flat":
            h, w, c = self.shape
            return (c, h, w)
        return self.shape


@dataclasses.dataclass
class Node:
    name: str
    layer: Layer
    inputs: Tuple[str, ...]
    preprocessor: Optional[object] = None
    in_shape: Optional[Tuple[int, ...]] = None
    out_shape: Optional[Tuple[int, ...]] = None


class GraphBuilder:
    """``NeuralNetConfiguration.Builder()...graphBuilder()`` equivalent."""

    def __init__(self, seed: int = prng.NUMBER_OF_THE_BEAST, l2: float = 0.0,
                 activation: str = "identity", weight_init: str = "xavier",
                 updater: Optional[RmsProp] = None,
                 clip_threshold: Optional[float] = None):
        self.seed = seed
        self.l2 = l2
        self.default_activation = activation
        self.weight_init = weight_init
        self.default_updater = updater
        self.clip_threshold = clip_threshold
        self.input_names: List[str] = []
        self.input_specs: Dict[str, InputSpec] = {}
        self.nodes: Dict[str, Node] = {}
        self.output_names: List[str] = []
        self._preprocessors: Dict[str, object] = {}

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self.input_names.extend(names)
        return self

    def set_input_types(self, *specs: InputSpec) -> "GraphBuilder":
        for name, spec in zip(self.input_names, specs):
            self.input_specs[name] = spec
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str) -> "GraphBuilder":
        if name in self.nodes or name in self.input_names:
            raise ValueError(f"duplicate node name {name!r}")
        for inp in inputs:
            if inp not in self.nodes and inp not in self.input_names:
                raise ValueError(f"layer {name!r}: unknown input {inp!r}")
        self.nodes[name] = Node(name=name, layer=layer, inputs=tuple(inputs))
        return self

    def input_preprocessor(self, layer_name: str, preproc) -> "GraphBuilder":
        self._preprocessors[layer_name] = preproc
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self.output_names = list(names)
        return self

    def _infer_input_shape(self, input_name: str) -> Tuple[int, ...]:
        """DL4J infers an input's size from its first consumer's nIn when no
        InputType is given (the insurance discriminator does this): the
        first consumer that declares ``n_in``, else ``n``."""
        for node in self.nodes.values():
            if input_name in node.inputs:
                n_in = getattr(node.layer, "n_in", None)
                if n_in is None:
                    n_in = getattr(node.layer, "n", None)
                if n_in is not None:
                    return (int(n_in),)
        raise ValueError(
            f"input {input_name!r}: no InputType set and no consumer declares nIn")

    def build(self, device=None) -> "ComputationGraph":
        """``device``: None = the card (raises when there is none).  An
        input without ``set_input_types`` becomes a feed-forward input of
        its consumer's declared size."""
        if not self.output_names:
            raise ValueError("set_outputs() not called")
        shapes = {}
        specs = dict(self.input_specs)
        for inp in self.input_names:
            if inp not in specs:
                specs[inp] = InputSpec.feed_forward(self._infer_input_shape(inp)[0])
            shapes[inp] = specs[inp].node_shape()
        resolved: Dict[str, Node] = {}
        for name, node in self.nodes.items():
            layer = node.layer.resolved(self.default_activation, self.default_updater)
            if layer.weight_init == "xavier":
                layer = dataclasses.replace(layer, weight_init=self.weight_init)
            pre = self._preprocessors.get(name)
            in_shapes = [shapes[i] for i in node.inputs]
            if layer.multi_input:
                if pre is not None:
                    raise ValueError(
                        f"vertex {name!r}: preprocessors are not supported "
                        "on multi-input vertices (attach one to the "
                        "consuming layer instead)")
                in_shape = in_shapes
            else:
                if len(in_shapes) != 1:
                    raise ValueError(
                        f"layer {name!r} expects exactly one input")
                in_shape = in_shapes[0]
                if pre is not None:
                    in_shape = pre.out_shape(in_shape)
            out_shape = layer.out_shape(in_shape)
            resolved[name] = Node(name, layer, node.inputs, pre, in_shape, out_shape)
            shapes[name] = out_shape
        return ComputationGraph(
            nodes=resolved, input_names=list(self.input_names),
            input_specs=specs,
            output_names=list(self.output_names), seed=self.seed, l2=self.l2,
            clip_threshold=self.clip_threshold, device=device)


class ComputationGraph:
    """The runnable graph: topology + params + updater state on one device."""

    def __init__(self, nodes: Dict[str, Node], input_names: List[str],
                 input_specs: Dict[str, InputSpec], output_names: List[str],
                 seed: int, l2: float, clip_threshold: Optional[float],
                 frozen: Optional[frozenset] = None, device=None):
        self.device = backend.resolve_device(device)
        self.nodes = nodes
        self.input_names = input_names
        self.input_specs = input_specs
        self.output_names = output_names
        self.seed = seed
        self.l2 = l2
        self.clip_threshold = clip_threshold
        self.frozen = frozenset(frozen or ())
        self.updater = GraphUpdater(
            {name: node.layer.updater for name, node in nodes.items()
             if node.layer.has_params and name not in self.frozen},
            l2=l2, clip_threshold=clip_threshold)
        self.params: Tree = {}
        self.opt_state: Tree = {}
        self._step_count = 0
        self.listeners: List = []  # DL4J TrainingListener surface

    # -- init ---------------------------------------------------------------

    def init(self, seed: Optional[int] = None) -> "ComputationGraph":
        """Deterministic per-layer init from a generator named after the
        layer, drawn on the CPU and then moved: the same seed gives the
        same params on every device, and same-named layers of two graphs
        get the same values."""
        seed = self.seed if seed is None else seed
        params = {}
        for name, node in self.nodes.items():
            lp = (node.layer.init(prng.generator(seed, name), node.in_shape)
                  if node.layer.has_params else {})
            params[name] = {k: v.to(self.device) for k, v in lp.items()}
        self.params = params
        self.opt_state = self.updater.init(params)
        return self

    # -- forward ------------------------------------------------------------

    def _forward(self, params: Tree, inputs: Dict[str, torch.Tensor],
                 train: bool, gen: Optional[torch.Generator] = None,
                 group: Optional[mesh.DataGroup] = None):
        """Forward over the DAG in insertion (topological) order.  Returns
        (values, state_updates): every node's output by name, plus the BN
        running-stat updates of train-mode layers.  ``group`` turns on
        sync-BN: the inputs are this rank's rows, the batch statistics the
        global batch's.  The ``--mp`` casts (module docstring) follow the
        policy at the call."""
        mp = backend.config().compute_bf16
        values: Dict[str, torch.Tensor] = {}
        for inp in self.input_names:
            x = inputs[inp]
            spec = self.input_specs[inp]
            if spec.kind == "cnn_flat":
                h, w, c = spec.shape
                x = x.reshape(x.shape[0], c, h, w)
            values[inp] = _down(x) if mp else x
        state_updates: Dict[str, Dict[str, torch.Tensor]] = {}
        for name, node in self.nodes.items():
            is_bn = isinstance(node.layer, (BatchNorm, ConditionalBatchNorm))
            if node.layer.multi_input:
                x = [values[i] for i in node.inputs]
                if mp and is_bn:
                    x = [x[0].float()] + x[1:]
            else:
                x = values[node.inputs[0]]
                if node.preprocessor is not None:
                    x = node.preprocessor(x)
                if mp and is_bn:
                    x = x.float()
            p = params[name]
            if mp and not is_bn:
                p = {k: _down(v) for k, v in p.items()}
            y, upd = node.layer.apply(p, x, train and name not in self.frozen,
                                      gen, group)
            if mp:
                y = _down(y)
            if upd:
                state_updates[name] = upd
            values[name] = y
        return values, state_updates

    def output(self, *xs: torch.Tensor, params: Optional[Tree] = None
               ) -> List[torch.Tensor]:
        """Inference forward (running BN stats, no dropout) — DL4J
        ``ComputationGraph.output``: one tensor per input, in the order of
        ``input_names``; ``params`` (e.g. the EMA weights) in place of the
        graph's own.  Returns a list, one per output layer."""
        with torch.no_grad():
            values, _ = self._forward(
                self.params if params is None else params,
                dict(zip(self.input_names, xs)), False)
        return [values[n] for n in self.output_names]

    # -- training -----------------------------------------------------------

    def _loss(self, outputs: Dict[str, torch.Tensor],
              labels: Dict[str, torch.Tensor]) -> torch.Tensor:
        total = 0.0
        for name in self.output_names:
            loss_name = getattr(self.nodes[name].layer, "loss", "mse")
            # f32 loss in every mode: under --mp the head arrives bf16
            total = total + loss_lib.get(loss_name)(outputs[name].float(),
                                                    labels[name])
        return total

    def _train_step(self, params: Tree, opt_state: Tree,
                    inputs: Dict[str, torch.Tensor],
                    labels: Dict[str, torch.Tensor],
                    gen: Optional[torch.Generator] = None,
                    group: Optional[mesh.DataGroup] = None,
                    reduce: Optional[Callable] = None,
                    telemetry: bool = False):
        """One optimization step -> (new_params, new_opt_state, loss).

        Every param leaf gets a gradient (zero where the loss does not
        reach it, e.g. BN running stats) and goes through the updater, as
        ``jax.value_and_grad`` over the whole tree does in the JAX package;
        the BN state updates then overwrite mean/var.  ``group`` runs the
        forward with sync-BN; ``reduce(loss, state_updates, grads)`` is
        applied after the gradients and before the updater (the
        data-parallel layer's mean over ranks, ``mesh.reducer``).
        ``telemetry`` adds a fourth return: the in-graph numerics block
        (``telemetry/ingraph.py`` ``graph_telemetry``) of the old params,
        the new ones (BN statistics as the state updates overwrote them),
        the reduced gradients and the loss."""
        leaves = {layer: {n: t.detach().requires_grad_(True) for n, t in lp.items()}
                  for layer, lp in params.items()}
        values, state_updates = self._forward(leaves, inputs, True, gen, group)
        loss = self._loss({n: values[n] for n in self.output_names}, labels)
        keys = [(layer, n) for layer, lp in leaves.items() for n in lp]
        flat = torch.autograd.grad(loss, [leaves[l][n] for l, n in keys],
                                   allow_unused=True)
        grads: Tree = {layer: {} for layer in leaves}
        for (layer, n), g in zip(keys, flat):
            grads[layer][n] = torch.zeros_like(params[layer][n]) if g is None else g
        loss = loss.detach()
        state_updates = {lname: {k: v.detach() for k, v in upd.items()}
                         for lname, upd in state_updates.items()}
        if reduce is not None:
            loss, state_updates, grads = reduce(loss, state_updates, grads)
        new_params, new_opt_state = self.updater.apply(params, grads, opt_state)
        for lname, upd in state_updates.items():
            new_params[lname].update(upd)
        if telemetry:
            tel = ingraph.graph_telemetry(params, new_params, grads, loss)
            return new_params, new_opt_state, loss, tel
        return new_params, new_opt_state, loss

    def _named(self, values, names: List[str]) -> Dict[str, torch.Tensor]:
        """A tensor (or array) for the single input/output, or a dict by
        name, as tensors on the graph's device."""
        if not isinstance(values, dict):
            values = dict(zip(names, [values]))
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in values.items()}

    def score_on(self, features, labels) -> float:
        """Inference-mode loss on a batch (no update, running BN stats, no
        dropout) — DL4J ``ComputationGraph.score(DataSet)``."""
        inputs = self._named(features, self.input_names)
        label_map = self._named(labels, self.output_names)
        with torch.no_grad():
            values, _ = self._forward(self.params, inputs, False)
            loss = self._loss({n: values[n] for n in self.output_names},
                              label_map)
        return float(loss)

    def fit(self, features, labels) -> torch.Tensor:
        """One optimization step on a batch — DL4J ``ComputationGraph.fit``,
        the unit the reference's ``SparkComputationGraph.fit`` reduces to per
        worker (``parallel/data_parallel.py`` for the distributed one).
        ``features``/``labels``: a tensor (or array) for the single
        input/output, or a dict by name.  Sets ``score``, fires the
        listeners and returns the loss (a 0-d tensor on the graph's
        device)."""
        inputs = self._named(features, self.input_names)
        label_map = self._named(labels, self.output_names)
        self._step_count += 1
        self.params, self.opt_state, loss = self._train_step(
            self.params, self.opt_state, inputs, label_map)
        self.score = loss
        for listener in self.listeners:
            listener.iteration_done(self, self._step_count, loss)
        return loss

    def set_listeners(self, *listeners) -> "ComputationGraph":
        """DL4J ``setListeners`` (replaces): listeners get
        ``iteration_done(model, iteration, score)`` after each eager
        ``fit``; the score arrives as a device scalar (``utils/listeners.py``
        for the readback-cost contract)."""
        self.listeners = list(listeners)
        return self

    def add_listeners(self, *listeners) -> "ComputationGraph":
        self.listeners.extend(listeners)
        return self

    # -- param access (the GAN protocol's weight-sync surface) ---------------

    def get_param(self, layer: str, name: str) -> torch.Tensor:
        return self.params[layer][name]

    def set_layer_params(self, layer: str, values: Dict[str, torch.Tensor]) -> None:
        self.params = {**self.params, layer: {**self.params[layer], **values}}

    def num_params(self) -> int:
        return sum(v.numel() for lp in self.params.values() for v in lp.values())
