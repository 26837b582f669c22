"""Data-parallel ``fit`` over a ``torch.distributed`` group — the
dl4j-spark replacement (torch twin of ``gan_deeplearning4j_tpu/parallel/
data_parallel.py``).

The reference trains through ``SparkComputationGraph.fit`` +
``ParameterAveragingTrainingMaster``.  Here every rank runs this object on
its own copy of the graph, in the same order, and passes the same global
batch; each rank trains on its equal share of the rows.

  - ``mode="gradient_sync"``: the ranks' gradients, losses and BN state
    updates are averaged before one shared RmsProp update, and BN uses the
    global batch's statistics (sync-BN).  With equal shares and mean
    losses this is the single-device fit on the whole batch.
  - ``mode="param_averaging"``: DL4J's protocol — every rank takes local
    RmsProp steps from the same params (BN on its local batch), and params
    AND updater state are averaged every ``averaging_frequency``
    minibatches of a ``fit_batches`` job and at the job's end.

``async_gradient_sharing`` and the two-tier ``dcn_axis`` schedule are not
ported yet (ROADMAP Queue 1 item 7.4).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from gan_deeplearning4j_tpu_torch.graph.graph import ComputationGraph
from gan_deeplearning4j_tpu_torch.parallel import mesh

_NOT_PORTED = ("is not ported yet (ROADMAP Queue 1 item 7.4: "
               "async_gradient_sharing, then the two-tier dcn_axis schedule)")


class DataParallelGraph:
    """``SparkComputationGraph`` equivalent over ``group``.  The wrapped
    graph's ``params``/``opt_state`` are the state between fits; after a
    fit they are equal on every rank."""

    def __init__(self, graph: ComputationGraph, group: mesh.DataGroup,
                 mode: str = "gradient_sync", averaging_frequency: int = 1,
                 dcn_axis: Optional[str] = None):
        if mode == "async_gradient_sharing":
            raise NotImplementedError(f"mode {mode!r} {_NOT_PORTED}")
        if mode not in ("gradient_sync", "param_averaging"):
            raise ValueError(f"unknown mode {mode!r}")
        if dcn_axis is not None:
            raise NotImplementedError(f"dcn_axis {_NOT_PORTED}")
        if averaging_frequency < 1:
            raise ValueError(f"averaging_frequency must be >= 1, got "
                             f"{averaging_frequency}")
        self.graph = graph
        self.group = group
        self.mode = mode
        self.averaging_frequency = averaging_frequency

    def _as_maps(self, features, labels):
        inputs = (features if isinstance(features, dict)
                  else dict(zip(self.graph.input_names, [features])))
        label_map = (labels if isinstance(labels, dict)
                     else dict(zip(self.graph.output_names, [labels])))
        return inputs, label_map

    def _share(self, tree: Dict[str, torch.Tensor], batch_dim: int):
        """This rank's rows of every array along ``batch_dim``."""
        out = {}
        for k, v in tree.items():
            v = torch.as_tensor(v, device=self.graph.device)
            B = v.shape[batch_dim]
            if B % self.group.world:
                raise ValueError(f"{k}: batch {B} does not split into "
                                 f"{self.group.world} equal shares")
            n = B // self.group.world
            out[k] = v.narrow(batch_dim, self.group.rank * n, n)
        return out

    def _step(self, inputs, labels, sync: bool):
        g = self.graph
        params, opt, loss = g._train_step(
            g.params, g.opt_state, inputs, labels,
            group=self.group if sync else None,
            reduce=mesh.reducer(self.group) if sync else None)
        g.params, g.opt_state = params, opt
        return loss

    def _average(self, loss: torch.Tensor) -> torch.Tensor:
        """Params, updater state and ``loss`` averaged over the ranks, in
        one collective; returns the mean loss."""
        g = self.graph
        g.params, g.opt_state, loss = mesh.all_reduce_mean(
            (g.params, g.opt_state, loss), self.group)
        return loss

    def fit(self, features, labels) -> torch.Tensor:
        """One job on a global batch — ``sparkX.fit(...)``.  Returns the
        mean loss over the ranks."""
        inputs, label_map = self._as_maps(features, labels)
        sync = self.mode == "gradient_sync"
        loss = self._step(self._share(inputs, 0), self._share(label_map, 0),
                          sync)
        if not sync:
            loss = self._average(loss)
        self.graph.score = loss
        return loss

    def fit_batches(self, features, labels) -> torch.Tensor:
        """A multi-minibatch job (param_averaging): arrays carry a leading
        [num_batches] axis; ranks average every ``averaging_frequency``
        batches and at the job's end — the full
        ``ParameterAveragingTrainingMaster`` schedule."""
        if self.mode != "param_averaging":
            raise ValueError("fit_batches is a param_averaging-mode API")
        inputs, label_map = self._as_maps(features, labels)
        inputs, label_map = self._share(inputs, 1), self._share(label_map, 1)
        k = next(iter(inputs.values())).shape[0]
        for i in range(k):
            loss = self._step({n: v[i] for n, v in inputs.items()},
                              {n: v[i] for n, v in label_map.items()},
                              sync=False)
            if (i + 1) % self.averaging_frequency == 0 and i + 1 < k:
                self._average(loss)
        loss = self._average(loss)
        self.graph.score = loss
        return loss
