"""The protocol step under each cuDNN algorithm policy, graphed and eager,
in turns on one card.

    python -m gan_deeplearning4j_tpu_torch.train.cudnn_ab [POLICY ...]

A policy sets ``torch.backends.cudnn.deterministic`` and ``.benchmark``
(TF32 stays off): ``heuristic`` (neither), ``deterministic``,
``det_benchmark`` (both) and ``benchmark``; the default runs all four.
The policies run in turns, first to last and back, each turn a fresh
process (cuDNN's algorithm choices are kept per process) that builds the
trainer at batch 200 on the card (which captures the step), then from the
graph's start runs two eager passes and one graphed pass of 20 steps
(calls of 10) and compares their losses and final states bit for bit, and
times the eager and the graphed step in turns (E G G E, each turn 5 calls
of 10 steps ending in their readback).  Prints one JSON line per turn,
then one summary line: each policy's mean times and whether every turn was
bitwise.  Needs one CUDA card; exits 1 without one.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time

POLICIES = {"heuristic": (False, False), "deterministic": (True, False),
            "det_benchmark": (True, True), "benchmark": (False, True)}
BATCH, K, CALLS, TURN_CALLS = 200, 10, 2, 5


def _digest(state) -> str:
    from gan_deeplearning4j_tpu_torch.train.fused_step import state_trees

    h = hashlib.sha256()
    for field, tree in state_trees(state):
        for layer in sorted(tree):
            for name, t in sorted(tree[layer].items()):
                h.update(f"{field}.{layer}.{name}".encode())
                h.update(t.detach().cpu().numpy().tobytes())
    h.update(str(int(state.it)).encode())
    return h.hexdigest()


def _turn(policy: str) -> dict:
    import torch

    from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as M
    from gan_deeplearning4j_tpu_torch.runtime import backend
    from gan_deeplearning4j_tpu_torch.train import fused_step
    from gan_deeplearning4j_tpu_torch.train.gan_trainer import GANTrainer

    det, bench = POLICIES[policy]

    def switches() -> None:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = det
        torch.backends.cudnn.benchmark = bench

    # every entry point sets the parity switches through this one function
    backend.set_f32_parity = switches
    t0 = time.perf_counter()
    trainer = GANTrainer(M.CVConfig(), batch_size=BATCH, n_train=10000,
                         device="cuda", steps_per_call=K)
    setup_s = time.perf_counter() - t0
    graphed = trainer.graphed
    start = fused_step.clone_state(graphed.state)
    z_start = trainer.z_gen.get_state()
    step = trainer.step_fn(K)
    inputs = (trainer.features, trainer.labels, trainer.y_real,
              trainer.y_fake, trainer.ones)

    def eager_pass():
        state = fused_step.clone_state(start)
        z_gen = torch.Generator(device=trainer.device)
        z_gen.set_state(z_start)
        losses = []
        for _ in range(CALLS):
            state, out = step(state, *inputs, z_gen=z_gen)
            losses.append(torch.stack(out, -1).cpu())
        return torch.cat(losses), _digest(state)

    (l1, d1), (l2, d2) = eager_pass(), eager_pass()
    lg = torch.cat([graphed(K) for _ in range(CALLS)])
    dg = _digest(graphed.state)
    box = {"state": fused_step.clone_state(start)}

    def eager():
        box["state"], out = step(box["state"], *inputs, z_gen=trainer.z_gen)
        torch.stack(out, -1).cpu()

    def turn(fn) -> float:
        times = []
        for _ in range(TURN_CALLS):
            t = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t)
        return statistics.median(times) / K * 1e3

    turns = [turn(eager), turn(lambda: graphed(K)), turn(lambda: graphed(K)),
             turn(eager)]
    return {"policy": policy, "deterministic": det, "benchmark": bench,
            "device": torch.cuda.get_device_name(0),
            "setup_s": setup_s, "capture": graphed.setup,
            "eager_repeat_bitwise": bool(torch.equal(l1, l2)) and d1 == d2,
            "graphed_eager_bitwise": bool(torch.equal(l1, lg)) and d1 == dg,
            "turns_ms": turns, "eager_ms": (turns[0] + turns[3]) / 2,
            "graphed_ms": (turns[1] + turns[2]) / 2}


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--turn":
        import torch

        if not torch.cuda.is_available():
            print("cudnn_ab: no CUDA card", file=sys.stderr)
            return 1
        print(json.dumps(_turn(argv[1])), flush=True)
        return 0
    names = argv or list(POLICIES)
    unknown = [n for n in names if n not in POLICIES]
    if unknown:
        print(f"cudnn_ab: unknown policies {unknown}; known: "
              f"{list(POLICIES)}", file=sys.stderr)
        return 2
    turns = []
    for name in names + names[::-1]:
        res = subprocess.run(
            [sys.executable, "-m", "gan_deeplearning4j_tpu_torch.train.cudnn_ab",
             "--turn", name], capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        turns.append(json.loads(line))
    summary = {}
    for name in names:
        mine = [t for t in turns if t["policy"] == name]
        summary[name] = {
            "eager_ms": statistics.mean(t["eager_ms"] for t in mine),
            "graphed_ms": statistics.mean(t["graphed_ms"] for t in mine),
            "setup_s": statistics.mean(t["setup_s"] for t in mine),
            "eager_repeat_bitwise": all(t["eager_repeat_bitwise"] for t in mine),
            "graphed_eager_bitwise": all(t["graphed_eager_bitwise"]
                                         for t in mine)}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
