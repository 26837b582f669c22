"""The combined-chaos scenario's loss bands on the CPU, seed by seed, for
the JAX package's runner and the port's.

    JAX_PLATFORMS=cpu python tests/scenario_bands.py --package jax --seeds 23 24 25
    python tests/scenario_bands.py --package torch --seeds 23 24 25

prints one JSON line a seed: the verdict's ``ok`` and failures, the trainer
exits, and each band's d/g relative gap.  ``band`` is the checked band:
the JAX runner's control reads the feed from before the corruption; the
port's reads the chaos run's own feed and reports the JAX control beside
it as ``band_clean_feed``.  Artifacts go under ``--out``.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _rels(block):
    return {k: v.get("rel") for k, v in (block or {}).items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--package", choices=("jax", "torch"), required=True)
    p.add_argument("--seeds", type=int, nargs="+", default=[23])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if args.package == "jax":
        from gan_deeplearning4j_tpu.scenario import run_scenario
        kw = {}
    else:
        from gan_deeplearning4j_tpu_torch.scenario import run_scenario
        kw = {"device": "cpu"}
    root = args.out or tempfile.mkdtemp(prefix="gan4j_bands_")
    for seed in args.seeds:
        t0 = time.monotonic()
        v = run_scenario(os.path.join(root, f"{args.package}_{seed}"),
                         seed=seed, log=lambda *a: None, **kw)
        print(json.dumps({
            "package": args.package, "seed": seed, "ok": v["ok"],
            "failures": v["failures"], "exits": v["trainer"]["exits"],
            "steps": (v["trainer"]["final"] or {}).get("step"),
            "band": _rels(v["band"]),
            "band_clean_feed": _rels(v.get("band_clean_feed")),
            "wall_s": round(time.monotonic() - t0, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
