"""Transfer-learning graph surgery (torch twin of ``gan_deeplearning4j_tpu/
graph/transfer.py``), the part ``build_classifier`` uses: new global
defaults, freezing every layer up to a feature extractor, removing a
vertex while keeping its wiring, and adding layers.  Retained layers carry
their params over by reference; new layers are initialized from the
fine-tune seed."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from gan_deeplearning4j_tpu_torch.graph.graph import ComputationGraph, GraphBuilder, Node
from gan_deeplearning4j_tpu_torch.graph.layers import Layer
from gan_deeplearning4j_tpu_torch.optim.rmsprop import RmsProp
from gan_deeplearning4j_tpu_torch.runtime import prng


@dataclasses.dataclass
class FineTuneConfiguration:
    seed: int = prng.NUMBER_OF_THE_BEAST
    l2: float = 0.0
    activation: str = "identity"
    weight_init: str = "xavier"
    updater: Optional[RmsProp] = None
    clip_threshold: Optional[float] = None


class TransferLearning:
    """``new TransferLearning.GraphBuilder(graph)`` equivalent."""

    def __init__(self, source: ComputationGraph):
        self.source = source
        self.fine_tune: Optional[FineTuneConfiguration] = None
        self._feature_extractor: Optional[str] = None
        self._removed: List[str] = []
        self._added: List[tuple] = []

    def fine_tune_configuration(self, cfg: FineTuneConfiguration) -> "TransferLearning":
        self.fine_tune = cfg
        return self

    def set_feature_extractor(self, layer_name: str) -> "TransferLearning":
        if layer_name not in self.source.nodes:
            raise ValueError(f"unknown layer {layer_name!r}")
        self._feature_extractor = layer_name
        return self

    def remove_vertex_keep_connections(self, name: str) -> "TransferLearning":
        self._removed.append(name)
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str) -> "TransferLearning":
        self._added.append((name, layer, inputs))
        return self

    def build(self) -> ComputationGraph:
        cfg = self.fine_tune or FineTuneConfiguration()
        builder = GraphBuilder(seed=cfg.seed, l2=cfg.l2, activation=cfg.activation,
                               weight_init=cfg.weight_init, updater=cfg.updater,
                               clip_threshold=cfg.clip_threshold)
        src = self.source
        builder.add_inputs(*src.input_names)
        builder.set_input_types(*[src.input_specs[i] for i in src.input_names])

        # every layer up to and including the feature extractor, in
        # insertion (topological) order — DL4J setFeatureExtractor
        frozen = set()
        if self._feature_extractor is not None:
            for name in src.nodes:
                frozen.add(name)
                if name == self._feature_extractor:
                    break

        # consumers of a removed vertex are rewired to its own inputs
        removed_inputs = {n: list(src.nodes[n].inputs) for n in self._removed}

        def _rewire(inputs):
            out: List[str] = []
            for inp in inputs:
                if inp in removed_inputs:
                    out.extend(_rewire(removed_inputs[inp]))
                else:
                    out.append(inp)
            return out

        kept: Dict[str, Node] = {}
        for name, node in src.nodes.items():
            if name in self._removed:
                continue
            # retained layers keep their resolved config (incl. activation)
            builder.add_layer(name, node.layer, *_rewire(node.inputs))
            if node.preprocessor is not None:
                builder.input_preprocessor(name, node.preprocessor)
            kept[name] = node
        for name, layer, inputs in self._added:
            # a vertex re-added under a removed name is a real node again
            removed_inputs.pop(name, None)
            builder.add_layer(name, layer, *_rewire(inputs))

        # DL4J keeps the original output names when the removed vertex was
        # re-added under the same name (the reference re-adds
        # "dis_output_layer_7")
        outputs = [n for n in src.output_names if n in builder.nodes]
        builder.set_outputs(*(outputs or [self._added[-1][0]]))

        graph = builder.build(device=src.device)
        graph.frozen = frozenset(frozen)
        graph.updater.layer_updaters = {
            name: node.layer.updater for name, node in graph.nodes.items()
            if node.layer.has_params and name not in graph.frozen}
        graph.init()
        for name in kept:
            graph.params = {**graph.params, name: dict(src.params[name])}
        return graph
