"""Two-graph GAN training for the roadmap families (torch twin of
``gan_deeplearning4j_tpu/train/gan_pair.py``): one generator graph, one
discriminator (critic) graph, and no weight copies — autograd flows
through D(G(z)) with D's params held constant.

Per iteration (``make_multistep``): ``n_critic`` D-steps, then one G-step,
then, with ``ema_decay``, the generator EMA.
  - D-step: fake = G(z) in inference mode under ``no_grad``; D trains on
    [real; fake] in one concatenated batch (its train-mode BN updates are
    merged into its params after the update).  ``mode="wgan-gp"`` adds
    ``gp_weight`` times the gradient penalty on alpha*real + (1-alpha)*fake,
    a second-order backward through the critic (run in inference mode).
  - G-step: D in inference mode (running BN statistics), the gradient
    taken over G's leaves only (D's params never require grad);
    ``ms_weight`` adds the mode-seeking term on a second latent z2 (with
    the same condition).
Labels: the D-step's real label is ``real_label`` in ``gan`` mode and 1 in
``wgan-gp``; the fake label 0, or -1 in ``wgan-gp``; the G-step's 1.

A conditional pair (a generator with a second input, cgan-cifar10's
one-hot ``label``) feeds the condition to both graphs under that input's
name: the D-step conditions G's fakes and D's real and fake halves on the
real rows' labels, the G-step draws rows of its own and conditions on
their labels (the JAX multistep's rule).

Random draws.  The JAX package derives each iteration's draws from the
iteration count (``fold_in(key0, it)``); torch cannot reproduce threefry,
so the port draws from one sequential ``torch.Generator`` (``z_gen``), in
this order per iteration: for each D-step the batch rows (uniform with
replacement), z ~ U[-1, 1) and, in ``wgan-gp``, alpha ~ U[0, 1) [B, 1];
then, for a conditional pair only, the G-step's rows; then the G-step's z
and, with ``ms_weight``, z2 (an unconditional pair draws no G-step
rows).  A checkpoint therefore saves the generator's state.  Tests inject the JAX
draws instead (``Draws``).

On one card ``make_multistep`` captures one iteration as a CUDA graph
(``fused_step.GraphedStep``) and a call replays it K times; on the CPU the
iteration runs eagerly.  The JAX data-parallel path (``mesh``) is not
ported yet: a ``group`` raises (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch

from gan_deeplearning4j_tpu_torch.graph.graph import ComputationGraph
from gan_deeplearning4j_tpu_torch.graph.layers import (
    BatchNorm,
    ConditionalBatchNorm,
    MinibatchStdDev,
)
from gan_deeplearning4j_tpu_torch.ops import losses as loss_lib
from gan_deeplearning4j_tpu_torch.optim import ema as ema_lib
from gan_deeplearning4j_tpu_torch.runtime import backend, prng
from gan_deeplearning4j_tpu_torch.train import fused_step

Tree = Dict[str, Dict]


class PairState(NamedTuple):
    """Both graphs' params and updater state, the iteration counter (a 0-d
    int64 tensor on the state's device) and the generator EMA (None when
    off) — the JAX scan carry ``(params_g, opt_g, params_d, opt_d, it,
    ema)``."""

    gen_params: Tree
    gen_opt: Tree
    dis_params: Tree
    dis_opt: Tree
    it: torch.Tensor
    ema: Optional[Tree] = None


class Draws(NamedTuple):
    """One iteration's random inputs, injected in place of ``z_gen``'s:
    per D-step the batch rows [B] (int64), z [B, z_size] and, in
    ``wgan-gp``, alpha [B, 1]; the G-step's z and, with ``ms_weight``,
    z2; for a conditional pair the G-step's rows [B] (int64), whose labels
    condition it."""

    d_idx: List[torch.Tensor]
    d_z: List[torch.Tensor]
    d_alpha: Optional[List[torch.Tensor]]
    g_z: torch.Tensor
    g_z2: Optional[torch.Tensor] = None
    g_idx: Optional[torch.Tensor] = None


def _detach(tree: Tree) -> Tree:
    return {k: {n: v.detach() for n, v in lp.items()} for k, lp in tree.items()}


def _grad_leaves(tree: Tree) -> Tree:
    return {k: {n: v.detach().requires_grad_(True) for n, v in lp.items()}
            for k, lp in tree.items()}


def _grads(loss: torch.Tensor, leaves: Tree) -> Tree:
    """d loss / d every leaf, zeros where the loss does not reach (BN
    running stats), as ``jax.value_and_grad`` over the whole tree gives."""
    keys = [(layer, n) for layer, lp in leaves.items() for n in lp]
    flat = torch.autograd.grad(loss, [leaves[l][n] for l, n in keys],
                               allow_unused=True)
    out: Tree = {layer: {} for layer in leaves}
    for (layer, n), g in zip(keys, flat):
        out[layer][n] = (torch.zeros_like(leaves[layer][n]) if g is None
                         else g)
    return out


def _uniform(shape, lo: float, hi: float, gen: torch.Generator,
             device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


class GANPair:
    def __init__(self, gen: ComputationGraph, dis: ComputationGraph,
                 mode: str = "gan", gp_weight: float = 10.0,
                 group=None, ms_weight: float = 0.0):
        if mode not in ("gan", "wgan-gp"):
            raise ValueError(f"unknown mode {mode!r}")
        if group is not None:
            raise NotImplementedError(
                "GANPair data parallelism is not ported yet (ROADMAP Queue 1 "
                "item 8: GANPair over torch.distributed)")
        if ms_weight < 0:
            raise ValueError(
                f"ms_weight must be >= 0, got {ms_weight} (a negative weight "
                "rewards mapping every z to the same image)")
        if mode == "wgan-gp":
            # the penalty takes every example's input gradient from ONE
            # gradient of the summed critic output: exact only for a critic
            # that couples no examples
            coupled = [name for name, node in dis.nodes.items()
                       if isinstance(node.layer, (BatchNorm,
                                                  ConditionalBatchNorm,
                                                  MinibatchStdDev))]
            if coupled:
                raise ValueError(
                    f"a wgan-gp critic must not couple examples; {coupled} "
                    "are BatchNorm / MinibatchStdDev layers")
        if gen.device != dis.device:
            raise ValueError(f"gen on {gen.device}, dis on {dis.device}")
        self.gen, self.dis = gen, dis
        # the condition's input name (the generator's second input), fed
        # to both graphs; None for an unconditional pair
        self.label_name = (gen.input_names[1] if len(gen.input_names) > 1
                           else None)
        if self.label_name is not None and \
                self.label_name not in dis.input_names:
            raise ValueError(
                f"the generator is conditioned on {self.label_name!r}, which "
                f"the discriminator does not take ({dis.input_names})")
        self.mode = mode
        self.gp_weight = float(gp_weight)
        self.ms_weight = float(ms_weight)
        self.device = gen.device
        # the public single steps' own draws (GP alpha, z2)
        self._gen = prng.generator(gen.seed, "gan-pair", self.device)

    # -- pure forwards -----------------------------------------------------

    def _cond(self, cond: Optional[torch.Tensor]) -> Dict:
        if (cond is None) != (self.label_name is None):
            raise ValueError(
                "a conditional pair needs its condition and an "
                "unconditional one takes none" if cond is None else
                "an unconditional pair takes no condition")
        return {} if cond is None else {self.label_name: cond}

    def _gen_forward(self, params: Tree, z: torch.Tensor, train: bool,
                     cond: Optional[torch.Tensor] = None):
        values, updates = self.gen._forward(
            params, {self.gen.input_names[0]: z, **self._cond(cond)}, train)
        out = values[self.gen.output_names[0]]
        return out.reshape(out.shape[0], -1), updates  # flat, dis-input layout

    def _dis_forward(self, params: Tree, x: torch.Tensor, train: bool,
                     cond: Optional[torch.Tensor] = None):
        values, updates = self.dis._forward(
            params, {self.dis.input_names[0]: x, **self._cond(cond)}, train)
        return values[self.dis.output_names[0]], updates

    def _dis_loss(self, out: torch.Tensor, labels: torch.Tensor):
        """The loss on D's head taken in f32, as ``ComputationGraph._loss``
        takes it and as the ``--mp`` recipe says.  The JAX pair passes the
        bf16 head as it is: its XENT clip bound 1 - 1e-7 then rounds to
        1.0, and a real row that D scores above ~0.998 under label
        smoothing gives an infinite loss (ROADMAP Queue 3)."""
        name = getattr(self.dis.nodes[self.dis.output_names[0]].layer, "loss",
                       "xent")
        return loss_lib.get(name)(out.float(), labels)

    # -- steps -------------------------------------------------------------

    def _d_step(self, pd: Tree, od: Tree, pg: Tree, real: torch.Tensor,
                z: torch.Tensor, y_real: torch.Tensor, y_fake: torch.Tensor,
                alpha: Optional[torch.Tensor] = None,
                cond_real: Optional[torch.Tensor] = None,
                cond_fake: Optional[torch.Tensor] = None,
                z_cond: Optional[torch.Tensor] = None):
        """-> (new dis params, new dis updater state, loss).  A conditional
        pair's D sees ``cond_real`` / ``cond_fake`` beside its halves, and
        G makes the fakes from ``z_cond`` (default: ``cond_fake``)."""
        z_cond = cond_fake if z_cond is None else z_cond
        with torch.no_grad():
            fake, _ = self._gen_forward(pg, z, False, z_cond)
        cond = None if cond_real is None else torch.cat([cond_real, cond_fake])
        leaves = _grad_leaves(pd)
        out, updates = self._dis_forward(leaves, torch.cat([real, fake]),
                                         True, cond)
        loss = self._dis_loss(out, torch.cat([y_real, y_fake]))
        if self.mode == "wgan-gp":
            # the penalty's critic: inference mode, the real rows' labels
            gp = loss_lib.gradient_penalty(
                lambda xi: self._dis_forward(leaves, xi, False, cond_real)[0],
                real, fake, alpha)
            loss = loss + self.gp_weight * gp
        grads = _grads(loss, leaves)
        new_params, new_opt = self.dis.updater.apply(pd, grads, od)
        for lname, upd in _detach(updates).items():
            new_params[lname] = {**new_params[lname], **upd}
        return new_params, new_opt, loss.detach()

    def _g_step(self, pg: Tree, og: Tree, pd: Tree, z: torch.Tensor,
                y_gen: torch.Tensor, z2: Optional[torch.Tensor] = None,
                cond_fake: Optional[torch.Tensor] = None,
                z_cond: Optional[torch.Tensor] = None):
        """-> (new gen params, new gen updater state, loss).  A conditional
        pair's G makes its fakes (and the mode-seeking z2's) from
        ``z_cond`` (default: ``cond_fake``), and D judges them under
        ``cond_fake``."""
        z_cond = cond_fake if z_cond is None else z_cond
        leaves = _grad_leaves(pg)
        fake, updates = self._gen_forward(leaves, z, True, z_cond)
        out, _ = self._dis_forward(pd, fake, False, cond_fake)
        loss = self._dis_loss(out, y_gen)
        if self.ms_weight:
            fake2, _ = self._gen_forward(leaves, z2, True, z_cond)
            img_d = torch.mean(torch.abs(fake - fake2))
            z_d = torch.mean(torch.abs(z - z2))
            loss = loss + self.ms_weight / (img_d / (z_d + 1e-8) + 1e-5)
        grads = _grads(loss, leaves)
        new_params, new_opt = self.gen.updater.apply(pg, grads, og)
        for lname, upd in _detach(updates).items():
            new_params[lname] = {**new_params[lname], **upd}
        return new_params, new_opt, loss.detach()

    # -- the fused iteration -------------------------------------------------

    def iteration(self, batch_size: int, n_critic: int, z_size: int,
                  ema_decay: float = 0.0):
        """One iteration as a step of ``fused_step``'s calling convention:
        ``(state, table, y_real, y_fake, y_gen, table_cond=None,
        z_gen=None, draws=None) -> (state', (d_loss, g_loss))``, the draws
        from ``z_gen`` unless ``draws`` (a ``Draws``) is given;
        ``table_cond`` [n, K] holds a conditional pair's row labels (the
        rows it gathers live in the graph's pool, as the table's do)."""
        B, wgan = batch_size, self.mode == "wgan-gp"
        # the precision policy the iteration is built under, as the JAX
        # multistep's trace fixes it
        policy = backend.config()

        def one(*args, **kwargs):
            with backend.configured(policy):
                return body(*args, **kwargs)

        def body(state: PairState, table, y_real, y_fake, y_gen,
                 table_cond=None, z_gen: Optional[torch.Generator] = None,
                 draws: Optional[Draws] = None):
            pg, og, pd, od, it, ema = state
            if draws is None:
                if z_gen is None:
                    raise ValueError("pass z_gen or draws")
                draws = self.draw(z_gen, table.shape[0], B, n_critic, z_size,
                                  table.device)

            def cond_of(idx):
                return (None if table_cond is None
                        else table_cond.index_select(0, idx))

            d_loss = None
            for j in range(n_critic):
                c = cond_of(draws.d_idx[j])
                pd, od, d_loss = self._d_step(
                    pd, od, pg, table.index_select(0, draws.d_idx[j]),
                    draws.d_z[j], y_real, y_fake,
                    draws.d_alpha[j] if wgan else None, c, c)
            pg, og, g_loss = self._g_step(
                pg, og, pd, draws.g_z, y_gen, draws.g_z2,
                None if table_cond is None else cond_of(draws.g_idx))
            if ema_decay:
                ema = ema_lib.ema_update(ema, pg, ema_decay)
            return PairState(pg, og, pd, od, it + 1, ema), (d_loss, g_loss)

        return one

    def draw(self, z_gen: torch.Generator, n_rows: int, batch_size: int,
             n_critic: int, z_size: int, device) -> Draws:
        """One iteration's draws from ``z_gen``, in the module's order."""
        B, wgan = batch_size, self.mode == "wgan-gp"
        idx, zs, alphas = [], [], []
        for _ in range(n_critic):
            idx.append(torch.randint(0, n_rows, (B,), generator=z_gen,
                                     device=device))
            zs.append(_uniform((B, z_size), -1.0, 1.0, z_gen, device))
            if wgan:
                alphas.append(torch.rand((B, 1), generator=z_gen,
                                         device=device))
        g_idx = (torch.randint(0, n_rows, (B,), generator=z_gen,
                               device=device)
                 if self.label_name is not None else None)
        z = _uniform((B, z_size), -1.0, 1.0, z_gen, device)
        z2 = (_uniform((B, z_size), -1.0, 1.0, z_gen, device)
              if self.ms_weight else None)
        return Draws(idx, zs, alphas if wgan else None, z, z2, g_idx)

    def label_vectors(self, batch_size: int, real_label: float = 1.0):
        """(y_real, y_fake, y_gen) [B, 1] on the pair's device."""
        dev = self.device
        y_real = torch.full((batch_size, 1), real_label, device=dev)
        y_fake = (-torch.ones((batch_size, 1), device=dev)
                  if self.mode == "wgan-gp"
                  else torch.zeros((batch_size, 1), device=dev))
        return y_real, y_fake, torch.ones((batch_size, 1), device=dev)

    def make_multistep(self, table_x: torch.Tensor, table_cond=None, *,
                       batch_size: int, steps_per_call: int,
                       n_critic: int = 1, real_label: float = 1.0,
                       z_size: int, z_gen: Optional[torch.Generator] = None,
                       ema_decay: float = 0.0, start_step: int = 0,
                       graphed: Optional[bool] = None):
        """K = ``steps_per_call`` iterations per call on the resident table
        (batches drawn uniformly with replacement).  Returns ``(step_fn,
        state0)``: ``step_fn(state, draws=None) -> (state', (d_losses[K],
        g_losses[K]))``; ``draws`` is a list of K ``Draws`` (eager only).

        ``graphed`` (default: on a CUDA table) captures one iteration as a
        CUDA graph at this call (``step_fn.graphed`` is the
        ``GraphedStep``): ``state0`` is then the graph's static state, the
        only state ``step_fn`` takes, and each call replays the graph K
        times and returns the state and the losses read back to the host.
        ``z_gen`` (default: ``prng.generator(gen.seed, "pair-multi")`` on
        the table's device) is registered with the graph.  ``start_step``
        seeds the counter; a resumed run also restores ``z_gen``.
        ``table_cond`` [n, K]: a conditional pair's one-hot row labels,
        resident beside the table (required for it, refused otherwise)."""
        if (table_cond is None) != (self.label_name is None):
            raise ValueError(
                "a conditional pair needs table_cond" if table_cond is None
                else "an unconditional pair takes no table_cond")
        if int(steps_per_call) != steps_per_call or steps_per_call < 1:
            raise ValueError(f"steps_per_call must be a positive int, got "
                             f"{steps_per_call}")
        if not 0.0 <= ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in [0, 1), got {ema_decay}")
        dev = table_x.device
        if z_gen is None:
            z_gen = prng.generator(self.gen.seed, "pair-multi", dev)
        one = self.iteration(batch_size, n_critic, z_size, ema_decay)
        inputs = (table_x,) + self.label_vectors(batch_size, real_label)
        if table_cond is not None:
            inputs += (table_cond,)
        state0 = PairState(
            self.gen.params, self.gen.opt_state, self.dis.params,
            self.dis.opt_state,
            torch.tensor(start_step, dtype=torch.int64, device=dev),
            ema_lib.ema_init(self.gen) if ema_decay else None)
        K = int(steps_per_call)
        if graphed is None:
            graphed = dev.type == "cuda"
        if graphed:
            g = fused_step.GraphedStep(one, state0, *inputs, z_gen=z_gen,
                                       ring=K, n_losses=2)

            def replay_fn(state: PairState, draws=None):
                if state is not g.state or draws is not None:
                    raise ValueError("the graphed multistep runs on its own "
                                     "static state (state0) and its own "
                                     "draws")
                out = g(K)
                return g.state, (out[:, 0], out[:, 1])

            replay_fn.graphed = g
            return replay_fn, g.state

        def step_fn(state: PairState, draws: Optional[List[Draws]] = None):
            ds, gs = [], []
            for k in range(K):
                state, (dl, gl) = one(state, *inputs, z_gen=z_gen,
                                      draws=None if draws is None
                                      else draws[k])
                ds.append(dl)
                gs.append(gl)
            return state, (torch.stack(ds), torch.stack(gs))

        step_fn.graphed = None
        return step_fn, state0

    def adopt_state(self, state: PairState) -> None:
        """Point both graphs at a multistep state (for dumps and saves)."""
        (self.gen.params, self.gen.opt_state, self.dis.params,
         self.dis.opt_state) = state[:4]
        if state.ema is not None:
            self.gen.ema_params = state.ema

    # -- public single steps ---------------------------------------------------

    def _z(self, z_inputs):
        """(z, the generator's condition or None) from a tensor or a dict
        by input name."""
        if not isinstance(z_inputs, dict):
            return z_inputs, None
        unknown = set(z_inputs) - set(self.gen.input_names)
        if unknown:
            raise ValueError(f"unknown generator inputs {sorted(unknown)}")
        return (z_inputs[self.gen.input_names[0]],
                z_inputs.get(self.label_name) if self.label_name else None)

    @staticmethod
    def _one(cond) -> Optional[torch.Tensor]:
        """A condition (a tensor, or the JAX API's {input name: labels})
        -> its one tensor, or None when empty."""
        if cond is None or isinstance(cond, torch.Tensor):
            return cond
        if not cond:
            return None
        if len(cond) != 1:
            raise ValueError(f"one condition input, got {sorted(cond)}")
        return next(iter(cond.values()))

    def d_step(self, real: torch.Tensor, z_inputs, cond_real=None,
               cond_fake=None, y_real=None, y_fake=None,
               alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One D-step on the graphs' own state -> the loss.  ``z_inputs``:
        z, or a dict by the generator's input names (z and, for a
        conditional pair, the fakes' labels); ``cond_real`` /
        ``cond_fake``: D's labels for the halves ({input name: labels}).
        Targets default to 1 and 0 (-1 in ``wgan-gp``); ``alpha`` defaults
        to a draw."""
        B = real.shape[0]
        if y_real is None:
            y_real = torch.ones((B, 1), device=self.device)
            y_fake = (-torch.ones((B, 1), device=self.device)
                      if self.mode == "wgan-gp"
                      else torch.zeros((B, 1), device=self.device))
        if self.mode == "wgan-gp" and alpha is None:
            alpha = torch.rand((B, 1), generator=self._gen, device=self.device)
        z, z_cond = self._z(z_inputs)
        self.dis.params, self.dis.opt_state, loss = self._d_step(
            self.dis.params, self.dis.opt_state, self.gen.params, real, z,
            y_real, y_fake, alpha, self._one(cond_real), self._one(cond_fake),
            z_cond)
        self.dis.score = loss
        return loss

    def g_step(self, z_inputs, cond_fake=None, y_gen=None,
               z2: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One G-step on the graphs' own state -> the loss.  ``z_inputs``
        as ``d_step``'s; ``cond_fake``: D's labels for the fakes."""
        z, z_cond = self._z(z_inputs)
        if y_gen is None:
            y_gen = torch.ones((z.shape[0], 1), device=self.device)
        if self.ms_weight and z2 is None:
            z2 = _uniform(tuple(z.shape), -1.0, 1.0, self._gen, self.device)
        self.gen.params, self.gen.opt_state, loss = self._g_step(
            self.gen.params, self.gen.opt_state, self.dis.params, z, y_gen,
            z2, self._one(cond_fake), z_cond)
        self.gen.score = loss
        return loss
