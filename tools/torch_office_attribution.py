"""Attribute an office run's 3D recall gap to visibility or to the method,
on vf_nerf_torch.

The port's counterpart of ``tools/office_attribution.py``, with its CLI and
its ``attribution.json``. Post-processes a ``tools/torch_office_protocol.py``
workdir: samples the GT mesh, splits the samples into camera-observed and
unobserved (a projective depth test against the GT depth maps) and reports
recall per surface group on each side, for the TSDF mesh and, when the
protocol ran it, the merged quadrant-MC mesh. Then probes the trained field
for zero crossings along lines through the column, the thin wall and the
desk, and measures the rendered-vs-GT depth and colour error per group.

Runs on CUDA unless given ``--gpu cpu``; imports nothing of the JAX
package.

Usage: python tools/torch_office_attribution.py [--workdir build/office]
       [--views 24] [--size 240 320] [--thresh 0.05] [--gpu cpu]
Writes <workdir>/attribution.json.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (REPO, os.path.join(REPO, "tools")):
    if path not in sys.path:
        sys.path.insert(0, path)

from torch_office_protocol import GROUPS, pixel_groups  # noqa: E402


def observed_mask(gt_pts, ds):
    """A GT-surface sample is observed iff some camera sees it within its
    GT depth map (2 cm of slack)."""
    import numpy as np

    h, w = ds.image_size
    fx, fy = ds.intrinsics[0, 0], ds.intrinsics[1, 1]
    cx, cy = ds.intrinsics[0, 2], ds.intrinsics[1, 2]
    depths = ds.depth_images.reshape(ds.n_images, h, w)
    obs = np.zeros(len(gt_pts), bool)
    for i, pose in enumerate(ds.poses):
        pc = (gt_pts - pose[:3, 3]) @ pose[:3, :3]
        z = pc[:, 2]
        u = np.round(pc[:, 0] / np.maximum(z, 1e-6) * fx + cx).astype(int)
        v = np.round(pc[:, 1] / np.maximum(z, 1e-6) * fy + cy).astype(int)
        ok = (z > 1e-3) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        dmap = depths[i][np.clip(v, 0, h - 1), np.clip(u, 0, w - 1)]
        obs |= ok & (z <= dmap + 0.02)
    return obs


def group_attribution(gt_pts, rects):
    """Index of the surface group owning each GT sample (nearest rect)."""
    import numpy as np

    from vf_nerf_torch.datasets.synthetic import _other_axes

    best_d2 = np.full(len(gt_pts), np.inf)
    best_g = np.zeros(len(gt_pts), int)
    for r in rects:
        a0, a1 = _other_axes(r.axis)
        q = gt_pts.copy()
        q[:, r.axis] = r.coord
        q[:, a0] = np.clip(gt_pts[:, a0], r.lo[0], r.hi[0])
        q[:, a1] = np.clip(gt_pts[:, a1], r.lo[1], r.hi[1])
        d2 = ((q - gt_pts) ** 2).sum(-1)
        upd = d2 < best_d2
        best_d2 = np.where(upd, d2, best_d2)
        best_g[upd] = r.group
    return best_g


def field_crossings(model, segments):
    """Sign flips of the normalized field along straight probe segments (a
    crossing: consecutive directions with a negative dot product)."""
    import numpy as np

    out = {}
    for name, (a, b, n) in segments.items():
        ts = np.linspace(0.0, 1.0, n)[:, None]
        pts = np.asarray(a) * (1 - ts) + np.asarray(b) * ts
        vf = model.get_vector_field(pts.astype(np.float32)).cpu().numpy()
        u = vf / np.maximum(np.linalg.norm(vf, axis=-1, keepdims=True),
                            1e-9)
        cos = (u[:-1] * u[1:]).sum(-1)
        flips = np.nonzero(cos < 0.0)[0]
        out[name] = [[float(v) for v in pts[i]] for i in flips]
    return out


def probe_segments(ds):
    """Lines through the column, the thin wall and the desk (the layout is
    authored at half_size 2 and scaled: column x[-1.3,-0.9] y[-0.5,-0.1],
    thin wall x[-0.3,-0.24] y[-1.7,-0.5], desk x[0.7,1.5] y[-1.6,-0.9]
    z[-2,-1.25])."""
    s = ds.half_size / 2.0
    return {
        "through_column": ([-1.99 * s, -0.3 * s, 0.0],
                           [0.5 * s, -0.3 * s, 0.0], 250),
        "through_thin_wall": ([-0.8 * s, -1.0 * s, 0.0],
                              [0.3 * s, -1.0 * s, 0.0], 200),
        "through_desk_horizontal": ([0.2 * s, -1.25 * s, -1.6 * s],
                                    [1.9 * s, -1.25 * s, -1.6 * s], 250),
        "through_desk_top": ([1.1 * s, -1.25 * s, -0.6 * s],
                             [1.1 * s, -1.25 * s, -1.95 * s], 250),
    }


def per_group_render_errors(ds, out_dir):
    """Rendered-vs-GT depth and colour error per surface group, from the
    eval's ``rendered_images`` (image-i.png and depth-i.npy); None when the
    depth maps are missing."""
    import numpy as np

    from vf_nerf_torch.utils import io as io_utils

    img_dir = os.path.join(out_dir, "rendered_images")
    if not os.path.exists(os.path.join(img_dir, "depth-0.npy")):
        return None
    depth_abs = np.zeros(len(GROUPS))
    rgb_abs = np.zeros(len(GROUPS))
    cnt = np.zeros(len(GROUPS), np.int64)
    for i, group in enumerate(pixel_groups(ds)):
        gt_rgb = ds.rgb_images[i].reshape(-1, 3)
        gt_depth = ds.depth_images[i].reshape(-1)
        pred_rgb = io_utils.load_rgb(
            os.path.join(img_dir, f"image-{i}.png"),
            transpose=False).reshape(-1, 3)
        pred_depth = np.load(
            os.path.join(img_dir, f"depth-{i}.npy")).reshape(-1)
        d_err = np.abs(pred_depth - gt_depth)
        c_err = np.abs(pred_rgb - gt_rgb).mean(-1)
        for g in range(len(GROUPS)):
            m = group == g
            depth_abs[g] += float(d_err[m].sum())
            rgb_abs[g] += float(c_err[m].sum())
            cnt[g] += int(m.sum())
    return {name: {"mean_abs_depth_err": float(depth_abs[g] /
                                               max(cnt[g], 1)),
                   "mean_abs_rgb_err": float(rgb_abs[g] / max(cnt[g], 1)),
                   "pixels": int(cnt[g])}
            for g, name in enumerate(GROUPS) if cnt[g]}


def recall_attribution(pr_v, gt_pts, obs, groups, thresh):
    """Recall of the GT samples overall, observed and unobserved, and per
    group, against the predicted vertices ``pr_v``."""
    from vf_nerf_torch.utils.meshes import _tree

    d, _ = _tree(pr_v).query(gt_pts, workers=-1)
    missed = d > thresh
    per_group = {}
    for gi, name in enumerate(GROUPS):
        m = groups == gi
        if not m.sum():
            continue
        mo = m & obs
        per_group[name] = {
            "gt_frac": float(m.mean()),
            "observed_frac": float(obs[m].mean()),
            "recall": float(1 - missed[m].mean()),
            "recall_observed": (float(1 - missed[mo].mean())
                                if mo.sum() else None),
        }
    return {
        "recall_overall": float(1 - missed.mean()),
        "observed_gt_fraction": float(obs.mean()),
        "recall_observed": float(1 - missed[obs].mean()),
        "recall_unobserved": float(1 - missed[~obs].mean()),
        "distance_thresh": thresh,
        "per_group": per_group,
    }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workdir", type=str,
                        default=os.path.join(REPO, "build", "office"))
    parser.add_argument("--views", type=int, default=24)
    parser.add_argument("--size", type=int, nargs=2, default=[240, 320])
    parser.add_argument("--pitch", type=float, default=1.1)
    parser.add_argument("--thresh", type=float, default=0.05)
    parser.add_argument("--samples", type=int, default=250000)
    parser.add_argument("--down-views", type=int, default=0,
                        help="must match the protocol's --down-views so "
                             "the rebuilt rig matches the trained poses")
    parser.add_argument("--gpu", type=str, default="auto",
                        help="'cpu' runs on the CPU; any other value on "
                             "CUDA")
    args = parser.parse_args(argv)

    from torch_office_protocol import office_dataset
    from vf_nerf_torch.config.parser import parse_config
    from vf_nerf_torch.models.nerf import VectorFieldNerf, resolve_device
    from vf_nerf_torch.utils.meshes import sample_surface
    from vf_nerf_torch.utils.ply import load_ply

    device = "cpu" if args.gpu == "cpu" else "cuda"
    resolve_device(device)            # raises without CUDA
    ds = office_dataset(args.views, args.size, args.pitch, args.down_views)
    gt_v, gt_f = load_ply(os.path.join(args.workdir, "Replica",
                                       "office_mesh.ply"))
    out_dir = os.path.join(args.workdir, "evals", "office_office",
                           "run_latest")
    gt_pts = sample_surface(gt_v, gt_f, args.samples, 0)
    obs = observed_mask(gt_pts, ds)
    groups = group_attribution(gt_pts, ds.rects)

    pr_v, _ = load_ply(os.path.join(out_dir, "tsdf-mesh", "tsdf.ply"))
    summary = recall_attribution(pr_v, gt_pts, obs, groups, args.thresh)
    mc_path = os.path.join(out_dir, "merged-mesh",
                           "merged-mesh-scaled-latest.ply")
    if os.path.exists(mc_path):
        mc_v, _ = load_ply(mc_path)
        if len(mc_v):
            summary["mc_mesh"] = recall_attribution(mc_v, gt_pts, obs,
                                                    groups, args.thresh)

    errs = per_group_render_errors(ds, out_dir)
    if errs is not None:
        summary["render_errors_per_group"] = errs
    print(json.dumps(summary, indent=1), flush=True)

    cfg = parse_config(scene="office",
                       config_path=os.path.join(args.workdir, "run.conf"),
                       gpu=args.gpu, expname="office", timestamp="run",
                       checkpoint="latest", data_root_dir=args.workdir,
                       offline=True)
    model = VectorFieldNerf(cfg.vf_nerf_config, seed=0, device=device)
    model.load(os.path.join(args.workdir, "exps", "office_office", "run",
                            "checkpoints", "vf_nerf", "latest.ckpt"))
    model.eval()
    summary["field_crossings"] = field_crossings(model, probe_segments(ds))
    print("field crossings:",
          {k: len(v) for k, v in summary["field_crossings"].items()},
          flush=True)

    with open(os.path.join(args.workdir, "attribution.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"wrote {os.path.join(args.workdir, 'attribution.json')}")
    return summary


if __name__ == "__main__":
    main()
