"""The DCGAN protocol step (torch twin of ``make_protocol_step`` in
``gan_deeplearning4j_tpu/train/fused_step.py``, its resident-data form: on
one device or data-parallel over a ``torch.distributed`` group, K steps
per call, with the generator EMA).

One step, in order:
  1. a D-step on [real; G(z1)], with the generator in inference mode;
  2. the dis -> gan sync of the frozen discriminator tail;
  3. a G-step through the stacked gan graph on z2;
  4. the gan -> gen sync;
  5. the dis -> classifier sync and a classifier step on the labeled batch;
  6. with ``ema_decay``, the EMA of the generator's params.

Syncs are dict merges that alias tensors; every update is out of place, so
an aliased tensor never changes under a graph that still reads it.

The step counter ``state.it`` is a 0-d int64 tensor on the state's device,
and the step slices its batch there: rows ``(it % n_batches) * B`` on, by
an index gather (the JAX step's ``dynamic_slice_in_dim``), so the host
never reads the counter back.  ``steps_per_call`` K > 1 runs K steps per
call and returns each loss stacked [K], as the JAX step's ``lax.scan``
does; torch has no scan carry, so JAX's ``carry_dedup`` (a fix for XLA's
carry copies) has no counterpart.  ``data_codec="u8x100"`` takes the
table as uint8 codes (data/codec.py) and decodes each sliced batch through
the 256-entry f32 table, bitwise the f32 table's step.  ``telemetry`` adds the JAX step's
in-graph numerics block (``telemetry/ingraph.py``): each trained graph's
gradient norm, parameter norm and update ratio (``d_``/``g_``/``clf_``)
and one total NaN/Inf count, [K] each under K steps a call.
``chunk_indexed`` (the streaming tier's dedup mode): the step takes a
row-index schedule after ``labels`` and ``real``/``labels`` are the
distinct-row tables; step ``it`` gathers the table rows
``row_idx[(it % n_batches) * B:]`` (``n_batches`` the schedule's batches).

On one card the trainer runs the step as a CUDA graph (``GraphedStep``):
captured once, a call replays it K times, the graph's launches replacing
the ~600 that eager PyTorch issues from Python a step.  Each replay writes
its losses, and the telemetry block when the step has one, to one row of
a ring on the card, and a call reads the ring back once.  The CPU and
data-parallel groups run the step eagerly (gloo cannot be captured; NCCL
capture is ROADMAP Queue 1 item 7.2).

Data parallel (``group``, the JAX package's mesh path): every rank holds
the whole resident table and the global target vectors, takes its B/n rows
of each, draws the full global latents (the same generator seed on every
rank, so the same tensor) and keeps its rows, runs the BNs on the global
batch's statistics (sync-BN), and averages loss, BN state updates and
gradients over the ranks before the updater.  Every rank then applies the
same update to the same state, so the ranks' states stay bitwise equal.
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from gan_deeplearning4j_tpu_torch.data.codec import U8X100_TABLE
from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
from gan_deeplearning4j_tpu_torch.optim import ema as ema_lib
from gan_deeplearning4j_tpu_torch.parallel import mesh
from gan_deeplearning4j_tpu_torch.runtime import backend
from gan_deeplearning4j_tpu_torch.utils import device as device_lib

# Cap on protocol steps per call (the JAX package's, fused_step.py:42): the
# trainer's K is the largest divisor of the run at most this.
MAX_STEPS_PER_CALL = 100


class ProtocolState(NamedTuple):
    """All four graphs' learnable state, the step counter (a 0-d int64
    tensor on the state's device) and the generator EMA (None when off)."""

    dis_params: Dict
    dis_opt: Dict
    gan_params: Dict
    gan_opt: Dict
    clf_params: Dict
    clf_opt: Dict
    gen_params: Dict
    it: torch.Tensor
    ema_gen: Optional[Dict] = None


# the state's {layer: {param: tensor}} trees, without the EMA
TREES = ProtocolState._fields[:7]

# the telemetry block's keys in the JAX step's order (fused_step.py: the
# three graphs' norms and ratios, then the one NaN/Inf count)
TELEMETRY_KEYS = tuple(
    f"{pfx}_{k}" for pfx in ("d", "g", "clf")
    for k in ("grad_norm", "param_norm", "update_ratio")) + ("nonfinite",)


def state_trees(state) -> List[Tuple[str, Dict]]:
    """(field, tree) for every tree of a step state (a NamedTuple whose
    fields are trees, 0-d tensors such as the counter ``it``, or None), in
    field order: for ``ProtocolState`` the seven graphs' trees, then the
    EMA when on."""
    return [(f, v) for f, v in zip(state._fields, state)
            if isinstance(v, dict)]


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error of an option whose port is still to come."""
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 "
                               f"item {item})")


# the u8x100 decode table on each device it has been put on
_DECODE_TABLES: Dict[torch.device, torch.Tensor] = {}


def decode_u8x100(codes: torch.Tensor) -> torch.Tensor:
    """uint8 codes -> their f32 values through ``U8X100_TABLE``, bitwise
    the f32 table's (put on the codes' device at its first call, which for
    a captured step is the warm-up, outside the capture)."""
    table = _DECODE_TABLES.get(codes.device)
    if table is None:
        table = torch.from_numpy(U8X100_TABLE).to(codes.device)
        _DECODE_TABLES[codes.device] = table
    return table.index_select(0, codes.reshape(-1).long()).view(codes.shape)


def _apply_sync(dst_params: Dict, src_params: Dict, mapping) -> Dict:
    """The reference's setParam block as a dict merge (tensor aliasing)."""
    out = dict(dst_params)
    for dst_layer, src_layer, names in mapping:
        out[dst_layer] = {**out[dst_layer],
                          **{n: src_params[src_layer][n] for n in names}}
    return out


def batch_rows(it: torch.Tensor, n_rows: int, B: int, rank: int = 0,
               world: int = 1) -> torch.Tensor:
    """The table rows of step ``it`` for ``rank``: ``(it % n_batches) * B
    + rank * B/world`` and the B/world rows after it, as an index tensor on
    ``it``'s device (``n_batches = n_rows // B``; the partial last batch is
    never used, as the JAX step's floor division drops it)."""
    Bl = B // world
    off = (it % (n_rows // B)) * B + rank * Bl
    return off + torch.arange(Bl, device=it.device)


def indexed_rows(it: torch.Tensor, row_idx: torch.Tensor, B: int,
                 rank: int = 0, world: int = 1) -> torch.Tensor:
    """The table rows of step ``it`` for ``rank`` under a row-index
    schedule (``chunk_indexed``): ``batch_rows`` of the schedule, looked
    up in it (the JAX step's ``dynamic_slice_in_dim`` then ``jnp.take``)."""
    return row_idx.index_select(
        0, batch_rows(it, row_idx.shape[0], B, rank, world))


def make_protocol_step(dis, gen, gan, classifier, dis_to_gan, gan_to_gen,
                       dis_to_classifier, z_size: int, num_features: int,
                       group: Optional[mesh.DataGroup] = None,
                       steps_per_call: int = 1, ema_decay: float = 0.0,
                       data_codec: Optional[str] = None,
                       chunk_indexed: bool = False, telemetry: bool = False):
    """Build the step:
    (state, real, labels, y_real, y_fake, ones, z_gen=None, z1=None, z2=None)
    -> (state', (d_loss, g_loss, clf_loss)), or with ``telemetry``
    (state', ((d_loss, g_loss, clf_loss), block)), ``block`` the flat
    ``TELEMETRY_KEYS`` dict of the JAX step.

    ``real``/``labels`` are the resident training table; the step slices
    batch ``it % (rows // B)`` itself, with B the rows of ``ones`` (the
    global batch).  ``y_real``/``y_fake``/``ones`` are the (pre-softened)
    [B, 1] targets.  The latents are U[-1, 1) draws of shape [B, z_size]
    from the generator ``z_gen`` (z1 first, then z2), unless ``z1``/``z2``
    are given — tests inject the JAX package's own draws that way.  With a
    ``group`` of n ranks each rank trains on its B/n rows of all of these
    (B % n must be 0: the mean of the ranks' means is the global mean only
    for equal shares) and the losses returned are the global batch's.

    ``steps_per_call`` K > 1: one call runs K steps (each slicing its own
    batch) and returns each loss stacked [K]; injected latents are then
    [K, B, z_size] stacks.  ``ema_decay`` > 0 keeps ``state.ema_gen`` (seed
    it with ``state_from_graphs(..., ema=True)``) as
    ``ema_update(ema_gen, gen_params, ema_decay)`` after every step.

    ``data_codec="u8x100"``: ``real`` holds uint8 codes, decoded after
    slicing (``decode_u8x100``).

    ``chunk_indexed``: the step is
    (state, real, labels, row_idx, y_real, y_fake, ones, ...) with
    ``real``/``labels`` the distinct-row tables of a deterministic pass and
    ``row_idx`` a [n_batches * B] integer schedule of table rows; step ``it``
    trains on the rows ``row_idx[(it % n_batches) * B:][:B]`` (a rank on
    its share of them)."""
    if data_codec not in (None, "u8x100"):
        raise ValueError(f"unknown data_codec: {data_codec!r}")
    if int(steps_per_call) != steps_per_call or steps_per_call < 1:
        raise ValueError(f"steps_per_call must be a positive int, got "
                         f"{steps_per_call}")
    rank, world = (group.rank, group.world) if group is not None else (0, 1)
    reduce = mesh.reducer(group)
    # the precision policy the step is built under, as the JAX step's
    # trace fixes it
    policy = backend.config()

    def train(graph, params, opt, inputs, targets):
        out = graph._train_step(params, opt, inputs, targets, group=group,
                                reduce=reduce, telemetry=telemetry)
        return out if telemetry else (*out, None)

    def one(*args, **kwargs):
        with backend.configured(policy):
            return body(*args, **kwargs)

    def body(state: ProtocolState, real, labels, y_real, y_fake, ones,
             z_gen: Optional[torch.Generator] = None,
             z1: Optional[torch.Tensor] = None,
             z2: Optional[torch.Tensor] = None,
             row_idx: Optional[torch.Tensor] = None):
        B = ones.shape[0]
        if B % world:
            raise ValueError(f"global batch {B} does not split into {world} "
                             "equal shares")
        src = row_idx if chunk_indexed else real
        if src.shape[0] < B:
            raise ValueError(f"resident table has {src.shape[0]} rows, "
                             f"fewer than one batch of {B}")
        Bl = B // world
        mine = slice(rank * Bl, (rank + 1) * Bl)
        if chunk_indexed:
            rows = indexed_rows(state.it, row_idx, B, rank, world)
        else:
            rows = batch_rows(state.it, real.shape[0], B, rank, world)
        real, labels = real.index_select(0, rows), labels.index_select(0, rows)
        if data_codec:
            real = decode_u8x100(real)
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
        dis_params, dis_opt, d_loss, d_tel = train(
            dis, state.dis_params, state.dis_opt,
            {dis.input_names[0]: torch.cat([real, fake])},
            {dis.output_names[0]: torch.cat([y_real, y_fake])})
        # (2) dis -> gan frozen tail
        gan_params = _apply_sync(state.gan_params, dis_params, dis_to_gan)
        # (3) G-step through the stacked graph
        gan_params, gan_opt, g_loss, g_tel = train(
            gan, gan_params, state.gan_opt, {gan.input_names[0]: z2},
            {gan.output_names[0]: ones})
        # (4) gan generator -> standalone gen
        gen_params = _apply_sync(state.gen_params, gan_params, gan_to_gen)
        # (5) classifier on the labeled real batch
        clf_params = _apply_sync(state.clf_params, dis_params, dis_to_classifier)
        clf_params, clf_opt, c_loss, c_tel = train(
            classifier, clf_params, state.clf_opt,
            {classifier.input_names[0]: real},
            {classifier.output_names[0]: labels})
        # (6) the generator EMA
        ema_gen = state.ema_gen
        if ema_decay:
            ema_gen = ema_lib.ema_update(ema_gen, gen_params, ema_decay)
        new_state = ProtocolState(dis_params, dis_opt, gan_params, gan_opt,
                                  clf_params, clf_opt, gen_params,
                                  state.it + 1, ema_gen)
        losses = (d_loss, g_loss, c_loss)
        if not telemetry:
            return new_state, losses
        # one flat block: per-graph norms/ratios and a single total
        # NaN/Inf count (the alarm only needs which step went bad)
        tel = {f"{pfx}_{k}": v
               for pfx, blk in (("d", d_tel), ("g", g_tel), ("clf", c_tel))
               for k, v in blk.items() if k != "nonfinite"}
        tel["nonfinite"] = (d_tel["nonfinite"] + g_tel["nonfinite"]
                            + c_tel["nonfinite"])
        return new_state, (losses, tel)

    def multi(state: ProtocolState, real, labels, y_real, y_fake, ones,
              z_gen: Optional[torch.Generator] = None,
              z1: Optional[torch.Tensor] = None,
              z2: Optional[torch.Tensor] = None,
              row_idx: Optional[torch.Tensor] = None):
        steps = []
        for k in range(steps_per_call):
            state, out = one(state, real, labels, y_real, y_fake, ones,
                             z_gen, None if z1 is None else z1[k],
                             None if z2 is None else z2[k], row_idx)
            steps.append(out)
        if not telemetry:
            return state, tuple(torch.stack(ls) for ls in zip(*steps))
        losses = tuple(torch.stack(ls) for ls in zip(*(o[0] for o in steps)))
        return state, (losses, {k: torch.stack([o[1][k] for o in steps])
                                for k in TELEMETRY_KEYS})

    step = one if steps_per_call == 1 else multi
    if not chunk_indexed:
        return step

    def indexed(state: ProtocolState, real, labels, row_idx, y_real, y_fake,
                ones, z_gen: Optional[torch.Generator] = None,
                z1: Optional[torch.Tensor] = None,
                z2: Optional[torch.Tensor] = None):
        return step(state, real, labels, y_real, y_fake, ones, z_gen=z_gen,
                    z1=z1, z2=z2, row_idx=row_idx)

    return indexed


def state_from_graphs(dis, gen, gan, classifier, start_step: int = 0,
                      ema: bool = False) -> ProtocolState:
    """``ema``: seed the generator's EMA from ``gen.ema_params`` when the
    graph carries one, else from its live params (fresh buffers)."""
    return ProtocolState(
        dis.params, dis.opt_state, gan.params, gan.opt_state,
        classifier.params, classifier.opt_state, gen.params,
        torch.tensor(start_step, dtype=torch.int64, device=dis.device),
        ema_lib.ema_init(gen) if ema else None)


def state_to_graphs(state: ProtocolState, dis, gen, gan, classifier) -> None:
    dis.params, dis.opt_state = state.dis_params, state.dis_opt
    gan.params, gan.opt_state = state.gan_params, state.gan_opt
    classifier.params, classifier.opt_state = state.clf_params, state.clf_opt
    gen.params = state.gen_params
    gen.ema_params = state.ema_gen  # None unless the step keeps an EMA


def _clone_tree(tree: Dict) -> Dict:
    return {k: _clone_tree(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


def clone_state(state):
    """A copy of a step state in fresh buffers, one per leaf (leaves that
    share a tensor get one copy each); trees of any depth (Adam's updater
    state is {layer: {param: {m, v, t}}})."""
    return type(state)(*(
        _clone_tree(v) if isinstance(v, dict)
        else v.clone() if isinstance(v, torch.Tensor) else v
        for v in state))


def _tree_leaves(tree: Dict, prefix: Tuple) -> Dict[Tuple, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tree_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _leaves(state) -> Dict[Tuple, torch.Tensor]:
    """Every tensor of a step state by path: (field, layer, param, ...) for
    tree leaves, (field,) for a 0-d tensor field such as ``it``."""
    out = {}
    for f, v in zip(state._fields, state):
        if isinstance(v, dict):
            out.update(_tree_leaves(v, (f,)))
        elif isinstance(v, torch.Tensor):
            out[(f,)] = v
    return out


def copy_state_(dst, src) -> None:
    """Copy every leaf of ``src`` into the same leaf of ``dst``, one
    multi-tensor copy per dtype.  ``dst``'s leaves must be distinct buffers
    (``clone_state``'s), and no leaf of ``src`` may be a buffer of ``dst``
    at another place: the copies would then depend on their order."""
    d, s = _leaves(dst), _leaves(src)
    if d.keys() != s.keys():
        raise ValueError(f"copy_state_: the leaves differ: "
                         f"{sorted(set(d) ^ set(s))}")
    place = {id(t): key for key, t in d.items()}
    pairs: Dict[torch.dtype, List] = {}
    for key, a in d.items():
        b = s[key]
        if place.get(id(b), key) != key:
            raise ValueError(f"copy_state_: the source of {key} is the "
                             f"destination {place[id(b)]}")
        if a is not b:
            pairs.setdefault(a.dtype, []).append((a, b))
    for group in pairs.values():
        torch._foreach_copy_([a for a, _ in group], [b for _, b in group])


def pack_outputs(out) -> torch.Tensor:
    """A step's outputs as columns: its losses (any number), then, for a
    ``(losses, block)`` output, the telemetry block in ``TELEMETRY_KEYS``
    order, cast to the losses' dtype (the NaN/Inf count is exact in f32)
    -> [n] for one step, [K, n] for K."""
    if len(out) == 2 and isinstance(out[1], dict):
        losses, tel = out
        cols = [*losses, *(tel[k].to(losses[0].dtype) for k in TELEMETRY_KEYS)]
    else:
        cols = list(out)
    return torch.stack(cols, -1)


def unpack_rows(rows) -> Tuple[List[List[float]], Dict[str, List[float]]]:
    """Host rows [n, 3] or [n, 3 + len(TELEMETRY_KEYS)] of the protocol
    step (``pack_outputs``) -> (per-step [d, g, clf] losses, the telemetry
    columns by key, empty without telemetry)."""
    rows = rows.tolist()
    losses = [r[:3] for r in rows]
    tel = {}
    if rows and len(rows[0]) > 3:
        tel = {k: [r[3 + i] for r in rows]
               for i, k in enumerate(TELEMETRY_KEYS)}
    return losses, tel


def step_counter(state) -> torch.Tensor:
    """The 0-d step counter: ``state.it``, or tenant 0's of a fleet's [N]."""
    return state.it.reshape(-1)[0]


def graph_body(step, inputs, z_gen: Optional[torch.Generator], ring: int,
               state, losses: torch.Tensor, counter: torch.Tensor) -> None:
    """What the CUDA graph of ``GraphedStep`` records: one ``step`` from
    ``state`` (on the ``inputs``, random draws from ``z_gen`` where the step
    takes them), its outputs (``pack_outputs``) written to row ``counter %
    ring`` of ``losses`` [ring, n_losses] through a device index, the new
    state copied into ``state`` and the 0-d ``counter`` advanced by one.
    Everything the step reads from the old state, the telemetry block
    included, is computed before that copy."""
    slot = (counter % ring).view(1)
    new, out = step(state, *inputs, z_gen=z_gen)
    losses.index_copy_(0, slot, pack_outputs(out).view(1, -1))
    copy_state_(state, new)
    counter.add_(1)


def replay(graph, replays: int, per_replay: Dict[str, int]) -> None:
    """``replays`` back-to-back replays of ``graph`` on the current stream,
    counted as the kernel launches they make (``per_replay`` each)."""
    for _ in range(replays):
        graph.replay()
    kernels.add_launches(per_replay, replays)


class GraphedStep:
    """A single-card step as a CUDA graph: captured once, a call replays it
    K times back to back and reads the [K, n_losses] losses back once.  The
    protocol step (3 losses, 13 columns with its telemetry block) and
    ``GANPair``'s iteration (2) both run so, the fleet step
    (``train/fleet.py``: 3 a tenant) and a lifecycle cohort's masked step
    at one capacity (``train/lifecycle.py``: 3 a lane).

    The graph's inputs are static tensors: ``self.state`` (a copy of the
    start state, one buffer per leaf, that the step reads and, at its end,
    overwrites with the new state), ``inputs`` (the tables and targets, and
    whatever else the step reads, which a caller may overwrite in place
    between calls) and, where the step draws its latents from one, the
    generator ``z_gen``, registered with the graph so that each replay
    draws new latents exactly as an eager step would.  Replay j writes its
    losses to row ``counter % ring`` of ``self.losses``, ``counter`` a
    device counter of the graph's own, started at the start state's step
    counter (``step_counter``: ``it``, or tenant 0's of a fleet) and
    advanced by each replay.  Before the capture, one eager step on copies
    of the state and on a side stream builds every kernel and runs each
    one-time setup (the kernels' shared memory attributes, the cluster
    occupancy checks, cuBLAS and cuDNN handles); ``z_gen`` is then put
    back, so from the same start the first replay gives the bits of the
    first eager step.  A capture that fails raises.  The graph records the
    precision policy of its capture, and a call under another policy
    raises."""

    def __init__(self, step, state, *inputs: torch.Tensor,
                 z_gen: Optional[torch.Generator] = None,
                 ring: int = MAX_STEPS_PER_CALL, n_losses: int = 3):
        dev = inputs[0].device
        if dev.type != "cuda":
            raise ValueError(f"GraphedStep captures a CUDA graph; the table "
                             f"is on {dev}")
        self.ring = ring
        self.inputs = inputs
        self.policy = backend.config()
        self.state = clone_state(state)
        self.losses = torch.zeros((ring, n_losses), device=dev)
        self.steps = int(step_counter(state))
        self.counter = torch.full((), self.steps, dtype=torch.int64,
                                  device=dev)
        t0 = time.perf_counter()
        z_start = z_gen.get_state() if z_gen is not None else None
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            graph_body(step, self.inputs, z_gen, ring, clone_state(state),
                       torch.zeros_like(self.losses), self.counter.clone())
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        if z_gen is not None:
            z_gen.set_state(z_start)
        t1 = time.perf_counter()
        mem = torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)
        self.graph = torch.cuda.CUDAGraph()
        if z_gen is not None:
            self.graph.register_generator_state(z_gen)
        with kernels.captured_launches() as self.launches:
            with torch.cuda.graph(self.graph):
                graph_body(step, self.inputs, z_gen, ring, self.state,
                           self.losses, self.counter)
        torch.cuda.synchronize(dev)
        # what the set-up cost: wall seconds, and the device memory the
        # graph's private pool holds on to (allocated / reserved growth)
        self.setup = {
            "warmup_s": t1 - t0, "capture_s": time.perf_counter() - t1,
            "pool_allocated_bytes": torch.cuda.memory_allocated(dev) - mem[0],
            "pool_reserved_bytes": torch.cuda.memory_reserved(dev) - mem[1]}

    def launch(self, n: int) -> List[int]:
        """Enqueue ``n`` steps (1 <= n <= ring) -> the rows of ``losses``
        they fill, in step order.  Read them back before the next launch,
        which overwrites the ring."""
        if not 1 <= n <= self.ring:
            raise ValueError(f"a call runs 1 to {self.ring} steps, not {n}")
        if backend.config() != self.policy:
            raise ValueError(f"the graph was captured under {self.policy}, "
                             f"not under {backend.config()}")
        replay(self.graph, n, self.launches)
        rows = [(self.steps + i) % self.ring for i in range(n)]
        self.steps += n
        return rows

    def __call__(self, n: int) -> torch.Tensor:
        """Run ``n`` steps -> their losses, [n, n_losses] on the host, in
        step order (one polled readback, ``utils/device.py``)."""
        rows = self.launch(n)
        return torch.from_numpy(device_lib.readback(self.losses))[rows]
