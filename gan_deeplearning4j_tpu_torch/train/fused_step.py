"""The DCGAN protocol step (torch twin of ``make_protocol_step`` in
``gan_deeplearning4j_tpu/train/fused_step.py``: one step per call, resident
data, on one device or data-parallel over a ``torch.distributed`` group).

One step, in order:
  1. a D-step on [real; G(z1)], with the generator in inference mode;
  2. the dis -> gan sync of the frozen discriminator tail;
  3. a G-step through the stacked gan graph on z2;
  4. the gan -> gen sync;
  5. the dis -> classifier sync and a classifier step on the labeled batch.

Syncs are dict merges that alias tensors; every update is out of place, so
an aliased tensor never changes under a graph that still reads it.

Data parallel (``group``, the JAX package's mesh path): every rank holds
the whole resident table and the global target vectors, takes its B/n rows
of each, draws the full global latents (the same generator seed on every
rank, so the same tensor) and keeps its rows, runs the BNs on the global
batch's statistics (sync-BN), and averages loss, BN state updates and
gradients over the ranks before the updater.  Every rank then applies the
same update to the same state, so the ranks' states stay bitwise equal.
The JAX package's scan, codec, EMA, telemetry and carry-dedup paths have
no counterpart yet.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from gan_deeplearning4j_tpu_torch.parallel import mesh


class ProtocolState(NamedTuple):
    """All four graphs' learnable state and the step counter."""

    dis_params: Dict
    dis_opt: Dict
    gan_params: Dict
    gan_opt: Dict
    clf_params: Dict
    clf_opt: Dict
    gen_params: Dict
    it: int


def _apply_sync(dst_params: Dict, src_params: Dict, mapping) -> Dict:
    """The reference's setParam block as a dict merge (tensor aliasing)."""
    out = dict(dst_params)
    for dst_layer, src_layer, names in mapping:
        out[dst_layer] = {**out[dst_layer],
                          **{n: src_params[src_layer][n] for n in names}}
    return out


def make_protocol_step(dis, gen, gan, classifier, dis_to_gan, gan_to_gen,
                       dis_to_classifier, z_size: int, num_features: int,
                       group: Optional[mesh.DataGroup] = None):
    """Build the step:
    (state, real, labels, y_real, y_fake, ones, z_gen=None, z1=None, z2=None)
    -> (state', (d_loss, g_loss, clf_loss)).

    ``real``/``labels`` are the resident training table; the step slices
    batch ``it % (rows // B)`` itself, with B the rows of ``ones`` (the
    global batch).  ``y_real``/``y_fake``/``ones`` are the (pre-softened)
    [B, 1] targets.  The latents are U[-1, 1) draws of shape [B, z_size]
    from the generator ``z_gen`` (z1 first, then z2), unless ``z1``/``z2``
    are given — tests inject the JAX package's own draws that way.  With a
    ``group`` of n ranks each rank trains on its B/n rows of all of these
    (B % n must be 0: the mean of the ranks' means is the global mean only
    for equal shares) and the losses returned are the global batch's."""
    rank, world = (group.rank, group.world) if group is not None else (0, 1)
    reduce = mesh.reducer(group)

    def train(graph, params, opt, inputs, targets):
        return graph._train_step(params, opt, inputs, targets, group=group,
                                 reduce=reduce)

    def step(state: ProtocolState, real, labels, y_real, y_fake, ones,
             z_gen: Optional[torch.Generator] = None,
             z1: Optional[torch.Tensor] = None,
             z2: Optional[torch.Tensor] = None):
        B = ones.shape[0]
        if B % world:
            raise ValueError(f"global batch {B} does not split into {world} "
                             "equal shares")
        n_batches = real.shape[0] // B
        if n_batches < 1:
            raise ValueError(f"resident table has {real.shape[0]} rows, "
                             f"fewer than one batch of {B}")
        Bl = B // world
        mine = slice(rank * Bl, (rank + 1) * Bl)
        off = (state.it % n_batches) * B + rank * Bl
        real, labels = real[off:off + Bl], labels[off:off + Bl]
        dev = real.device
        if z1 is None or z2 is None:
            if z_gen is None:
                raise ValueError("pass z_gen, or both z1 and z2")
            z1 = torch.rand((B, z_size), generator=z_gen, device=dev) * 2 - 1
            z2 = torch.rand((B, z_size), generator=z_gen, device=dev) * 2 - 1
        z1, z2, y_real, y_fake, ones = (
            t[mine] for t in (z1, z2, y_real, y_fake, ones))
        # (1) D-step on [real; G(z1)] — the generator in inference mode;
        # the targets are concatenated per rank, so each rank's halves line
        # up with its own [real; fake]
        fake = gen.output(z1, params=state.gen_params)[0].reshape(Bl, num_features)
        dis_params, dis_opt, d_loss = train(
            dis, state.dis_params, state.dis_opt,
            {dis.input_names[0]: torch.cat([real, fake])},
            {dis.output_names[0]: torch.cat([y_real, y_fake])})
        # (2) dis -> gan frozen tail
        gan_params = _apply_sync(state.gan_params, dis_params, dis_to_gan)
        # (3) G-step through the stacked graph
        gan_params, gan_opt, g_loss = train(
            gan, gan_params, state.gan_opt, {gan.input_names[0]: z2},
            {gan.output_names[0]: ones})
        # (4) gan generator -> standalone gen
        gen_params = _apply_sync(state.gen_params, gan_params, gan_to_gen)
        # (5) classifier on the labeled real batch
        clf_params = _apply_sync(state.clf_params, dis_params, dis_to_classifier)
        clf_params, clf_opt, c_loss = train(
            classifier, clf_params, state.clf_opt,
            {classifier.input_names[0]: real},
            {classifier.output_names[0]: labels})
        new_state = ProtocolState(dis_params, dis_opt, gan_params, gan_opt,
                                  clf_params, clf_opt, gen_params, state.it + 1)
        return new_state, (d_loss, g_loss, c_loss)

    return step


def state_from_graphs(dis, gen, gan, classifier, start_step: int = 0
                      ) -> ProtocolState:
    return ProtocolState(dis.params, dis.opt_state, gan.params, gan.opt_state,
                         classifier.params, classifier.opt_state, gen.params,
                         start_step)


def state_to_graphs(state: ProtocolState, dis, gen, gan, classifier) -> None:
    dis.params, dis.opt_state = state.dis_params, state.dis_opt
    gan.params, gan.opt_state = state.gan_params, state.gan_opt
    classifier.params, classifier.opt_state = state.clf_params, state.clf_opt
    gen.params = state.gen_params
