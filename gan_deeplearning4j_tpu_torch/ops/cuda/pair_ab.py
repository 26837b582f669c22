"""Time the sync-BN pair's kernels of several checkouts in turns on one card.

    python3 gan_deeplearning4j_tpu_torch/ops/cuda/pair_ab.py ROOT [ROOT ...]

Each ROOT is the root of a checkout of this repo (``.`` for this one; an
older commit unpacked with ``git archive``).  The checkouts run in turns,
first to last and back (A B B A for two), each turn a fresh process that
builds that checkout's kernels and times them with ``chip_smoke.py``'s
``time_ms`` from THIS checkout, so every turn uses one timing method, on
the same seeded inputs: a 2-rank DCGAN step's per-rank shapes [100, 2],
[100, 6272], [100, 1024].  A turn times

  bn_moments   the three launches of ``kernels.bn_moments``, and each alone
  bn_apply     the three launches of ``kernels.bn_apply`` (mean and var
               given), and each alone
  bn_apply_sums  the three launches from the all-reduced sums, where the
               checkout has that entry
  floor        three and one empty launches (``torch.cuda._sleep(0)``)

and the largest difference of each kernel's outputs from its plain version.
Prints one JSON line per turn, then one summary line: for every name, each
checkout's mean over its turns.  Needs one CUDA card; exits 1 without one.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[3]
SHAPES = [(100, 2), (100, 7 * 7 * 128), (100, 1024)]


def _turn(root: str) -> dict:
    """The times of one checkout's pair kernels (runs in its own process)."""
    sys.path[0] = str(Path(root).resolve())  # that checkout's package
    import torch

    from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
    from gan_deeplearning4j_tpu_torch.ops.cuda import bn_act as bn2d

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(20261017)
    inputs = []
    for b, f in SHAPES:
        x = torch.randn((b, f), generator=gen, device=dev) * 0.5 + 0.2
        gm = torch.randn(f, generator=gen, device=dev) * 0.1 + 1.0
        bt = torch.randn(f, generator=gen, device=dev) * 0.1
        mean, m2 = bn2d.bn_moments_plain(x)
        inputs.append((x, gm, bt, mean, m2 - mean * mean,
                       torch.stack([mean, m2]) * 2))
    out = {"root": root, "err": {}}

    def group(name, fn, plain):
        err = max(float((a - b).abs().max())
                  for args in inputs for a, b in zip(fn(*args), plain(*args)))
        out["err"][name] = err
        out[name] = smoke.time_ms(lambda: [fn(*a) for a in inputs], torch)
        for (b, f), args in zip(SHAPES, inputs):
            out[f"{name}[{b},{f}]"] = smoke.time_ms(lambda: fn(*args), torch)

    group("bn_moments", lambda x, *_: kernels.bn_moments(x),
          lambda x, *_: bn2d.bn_moments_plain(x))
    group("bn_apply",
          lambda x, gm, bt, m, v, _: [kernels.bn_apply(x, m, v, gm, bt, 1e-5,
                                                       "tanh")],
          lambda x, gm, bt, m, v, _: [bn2d.bn_apply_plain(x, m, v, gm, bt,
                                                          1e-5, "tanh")])
    if hasattr(kernels, "bn_apply_sums"):
        group("bn_apply_sums",
              lambda x, gm, bt, m, v, s: kernels.bn_apply_sums(
                  x, s, 2, gm, bt, 1e-5, "tanh"),
              lambda x, gm, bt, m, v, s: bn2d.bn_apply_sums_plain(
                  x, s, 2, gm, bt, 1e-5, "tanh"))
    out["floor3"] = smoke.floor_ms(3, torch)
    out["floor1"] = smoke.floor_ms(1, torch)
    return out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--turn":
        import torch

        if not torch.cuda.is_available():
            print("pair_ab: no CUDA card", file=sys.stderr)
            return 1
        print(json.dumps(_turn(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    turns = []
    for root in argv + argv[::-1]:
        res = subprocess.run([sys.executable, __file__, "--turn", root],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        turns.append(json.loads(line))
    summary = {}
    for root in argv:
        mine = [t for t in turns if t["root"] == root]
        names = [k for k, v in mine[0].items() if isinstance(v, float)]
        summary[root] = {k: statistics.mean(t[k] for t in mine) for k in names}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
