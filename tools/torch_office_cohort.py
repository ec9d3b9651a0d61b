"""Assemble the port's office cohort record from per-seed runs.

Reads the ``office_s<seed>.json`` and ``attribution_s<seed>.json`` files
that ``tools/torch_office_protocol.py`` and
``tools/torch_office_attribution.py`` left in one directory, merges them
with ``tools/office_cohort.py``'s ``assemble`` (the JAX cohort's record
layout), and adds what the port's record needs beside it: each seed's card
(``nvidia-smi`` name and power limit), stage seconds, peak memory and
convergence flag, how each seed's run went (``--runs``: the git tree it ran
and the stages whose times were taken while another process used the same
card), the cohort's range, the seeds asked for but not run, the tree the
record was assembled on, and the JAX cohort's quality (its median and range
of PSNR and MC F-score, no TPU time) from ``results/office_r5.json``.

``--runs`` is a JSON file ``{"<seed>": {"tree": ..., "shared_card":
[<stage>, ...], "note": ...}}``; a seed it does not name gets the tree
``null`` (not recorded) and no shared stage.

Usage: python tools/torch_office_cohort.py --logdir chiprun_out/office \\
           --headline-seed 42 --seeds 42 1 2 3 7 --tree <git tree> \\
           --parent <git commit> [--runs runs.json] \\
           --out results/office_torch_h100.json
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

from office_cohort import assemble, load_cohort  # noqa: E402

QUALITY = ("mean_psnr", "mc_fscore")


def spread(rows, key):
    vals = [r[key] for r in rows if r.get(key) is not None]
    return {"min": min(vals), "max": max(vals)} if vals else None


def jax_quality(path):
    """The JAX cohort's median and range of PSNR and MC F-score."""
    with open(path) as f:
        ref = json.load(f)
    rows = list(ref["cohort"].values())
    return {"seeds": sorted(int(s) for s in ref["cohort"]),
            "median": {k: ref["cohort_median"][k] for k in QUALITY},
            "range": {k: spread(rows, k) for k in QUALITY}}


def build_record(logdir, headline_seed, seeds, tree, parent, runs=None,
                 jax_record=os.path.join(REPO, "results", "office_r5.json")):
    loaded = load_cohort(logdir)
    out = assemble(loaded, headline_seed)
    out["note"] = (
        "vf_nerf_torch on the H100: tools/torch_office_protocol.py at the "
        "JAX cohort's settings (24 views of 240x320, 2000 epochs, "
        "depth_loss_clamp 3.0, quadrant MC res 256 x 8); headline seed "
        f"{headline_seed} runs the full mesh trio and the TSDF metrics. "
        "Each seed's 'run' names the tree that ran and the stages timed "
        "while another process used the same card. Seeds are labels: "
        "torch's generators draw other streams than JAX's threefry.")
    out["cohort_range"] = {k: spread(out["cohort"].values(), k)
                           for k in QUALITY}
    for seed, row in out["cohort"].items():
        office = loaded[int(seed)]["office"]
        row["device"] = office["device"]
        row["eval_wall_s"] = office["eval_wall_s"]
        row["peak_memory_gb"] = office["peak_memory_gb"]
        row["convergence_flagged"] = office["convergence"]["flagged"]
        row["final_epoch_loss"] = office["final_epoch_loss"]
        row["run"] = dict({"tree": None, "shared_card": []},
                          **(runs or {}).get(str(seed), {}))
        unknown = (set(row["run"]["shared_card"]) -
                   set(row["eval_wall_s"]) - {"train"})
        if unknown:
            raise ValueError(f"seed {seed}: no stage {sorted(unknown)}")
    out["devices"] = sorted({row["device"] for row in out["cohort"].values()})
    out["any_seed_flagged"] = any(row["convergence_flagged"]
                                  for row in out["cohort"].values())
    out["seeds_not_run"] = sorted(set(seeds) - set(loaded))
    out["source"] = {"assembled_on_tree": tree, "parent_commit": parent}
    out["jax_cohort_quality"] = jax_quality(jax_record)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--logdir", required=True)
    parser.add_argument("--headline-seed", type=int, default=42)
    parser.add_argument("--seeds", type=int, nargs="+",
                        default=[42, 1, 2, 3, 7])
    parser.add_argument("--tree", required=True,
                        help="git tree hash the record is assembled on")
    parser.add_argument("--parent", required=True,
                        help="the commit that tree was made on")
    parser.add_argument("--runs", default=None,
                        help="JSON file: per seed, the tree that ran and "
                             "the stages timed beside another process")
    parser.add_argument("--out", default=os.path.join(
        REPO, "results", "office_torch_h100.json"))
    args = parser.parse_args(argv)
    runs = None
    if args.runs:
        with open(args.runs) as f:
            runs = json.load(f)
    out = build_record(args.logdir, args.headline_seed, args.seeds,
                       args.tree, args.parent, runs)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in ("cohort_median", "cohort_range",
                                          "seeds_not_run", "devices",
                                          "jax_cohort_quality")}, indent=1))
    return out


if __name__ == "__main__":
    main()
