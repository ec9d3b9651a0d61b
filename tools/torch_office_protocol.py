"""The office reconstruction protocol on vf_nerf_torch.

The port's counterpart of ``tools/office_protocol.py``, with its CLI, its
defaults and its ``office.json``: export the non-convex synthetic office
(L-shaped room, column, thin free-standing wall, desk) in Replica's layout,
fit the generic ``exterior_scene`` VF init, train the shipped conf for the
full 2000 epochs (static fine growth), render every view and score its
PSNR, fuse and score the TSDF meshes (``3d-metrics``), then run quadrant
marching cubes at res 256 x 8 and score the merged meshes. Adds the
edge-vs-interior and per-object-group PSNR breakdowns.

Runs on CUDA unless given ``--gpu cpu``; without a card it raises. It
imports nothing of the JAX package: the helpers below are this tool's own
copies of ``tools/office_protocol.py``'s and
``tools/convergence_variance.py``'s, built on ``vf_nerf_torch``.

Usage: python tools/torch_office_protocol.py [--views 24] [--size 240 320]
       [--epochs 2000] [--resolution 256] [--seed 42] [--mc plain|trio]
       [--depth-clamp 3.0] [--workdir build/office] [--gpu cpu]
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

CONF = os.path.join(REPO, "confs", "vf_nerf.conf")
GROUPS = ["walls", "floor", "ceiling", "corner_block", "column",
          "thin_wall", "desk"]
MC_FOLDERS = {"plain": "merged-mesh", "smoothed": "merged-mesh-smoothed",
              "smoothed-after": "merged-mesh-smoothed-after"}


# ------------------------------------------------------------ conf rewrite
def write_conf(workdir: str, epochs: int) -> str:
    """``<workdir>/run.conf``: the shipped conf with ``epochs`` epochs, a
    save every 500, the run under ``<workdir>/exps``, every Replica frame
    (``factor = 1``) and static fine growth."""
    conf_path = os.path.join(workdir, "run.conf")
    with open(CONF) as f:
        conf = f.read()
    conf = conf.replace("num_epochs = 3001", f"num_epochs = {epochs}")
    conf = conf.replace("save_frequency = 100", "save_frequency = 500")
    conf = conf.replace('exps_folder = "./exps_vf_nerf"',
                        f'exps_folder = "{os.path.join(workdir, "exps")}"')
    conf = conf.replace('data_dir = "Replica"',
                        'data_dir = "Replica"\n    factor = 1')
    conf += "\ndevice { static_fine_growth = True }\n"
    with open(conf_path, "w") as f:
        f.write(conf)
    return conf_path


def apply_depth_clamp(conf_path: str, value: float) -> None:
    """Set ``loss.config.depth_loss_clamp`` in a written run.conf. Raises if
    the shipped anchor ``depth_loss_clamp = 0.5`` is missing, so a clamp
    study never trains silently at 0.5."""
    with open(conf_path) as f:
        conf = f.read()
    anchor = "depth_loss_clamp = 0.5"
    if anchor not in conf:
        raise RuntimeError(
            f"{conf_path} has no '{anchor}' line to patch — refusing to "
            "run a clamp study against an unpatched conf")
    with open(conf_path, "w") as f:
        f.write(conf.replace(anchor, f"depth_loss_clamp = {value}"))


def apply_mask_invalid_depth(conf_path: str) -> None:
    """Arm ``loss.config.mask_invalid_depth`` on the line after the clamp."""
    with open(conf_path) as f:
        conf = f.read()
    anchor = "depth_loss_clamp = "
    if anchor not in conf:
        raise RuntimeError(f"{conf_path} has no '{anchor}' line to anchor "
                           "the mask_invalid_depth insert")
    lines = conf.splitlines()
    i = next(n for n, line in enumerate(lines) if anchor in line)
    indent = lines[i][:len(lines[i]) - len(lines[i].lstrip())]
    lines.insert(i + 1, f"{indent}mask_invalid_depth = true")
    with open(conf_path, "w") as f:
        f.write("\n".join(lines) + "\n")


# ------------------------------------------------------------------ scene
def corrupt_depth(depth, dropout, noise_sigma, seed=123):
    """Sensor corruption of depth maps: iid Gaussian noise of
    ``noise_sigma`` scene units (clipped at 0), then each pixel zeroed with
    probability ``dropout`` (holes)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    out = depth.copy()
    if noise_sigma > 0:
        out = np.maximum(out + rng.normal(0, noise_sigma, out.shape)
                         .astype(out.dtype), 0.0)
    if dropout > 0:
        out *= (rng.rand(*out.shape) >= dropout).astype(out.dtype)
    return out


def fit_scene_vf_init(ds, path, device=None, vf_config=None):
    """The generic ``exterior_scene`` VF init of a synthetic scene (800
    steps of 8,192 points, centre 0, wall radius 1.25 x half the deepest
    depth, extent 1.5 x that, seed 0), written by ``save_vf_init`` to
    ``path``."""
    import numpy as np

    from vf_nerf_torch.train.vf_init import (default_vf_config, fit_vf_init,
                                             save_vf_init)

    wall_radius = ds.max_depth * 1.25 / 2.0
    net, _ = fit_vf_init(vf_config or default_vf_config(), "exterior_scene",
                         np.zeros(3), sample_extent=1.5 * wall_radius,
                         wall_radius=wall_radius, steps=800, batch=8192,
                         seed=0, device=device)
    save_vf_init(path, net, "exterior_scene", wall_radius)


def office_dataset(n_images, image_size, pitch, extra_down_views=0):
    from vf_nerf_torch.datasets.synthetic import SyntheticOfficeDataset

    return SyntheticOfficeDataset(n_images=n_images,
                                  image_size=tuple(image_size),
                                  pixels_per_batch=1024, pitch_range=pitch,
                                  extra_down_views=extra_down_views)


def export_office(workdir, n_images, image_size, pitch,
                  depth_dropout=0.0, depth_noise=0.0, extra_down_views=0,
                  device=None, vf_config=None):
    """The office in Replica's layout under ``workdir`` and its VF init at
    ``Replica/office/office.pkl``; returns the scene with clean depths.
    Corruption applies to the exported (sensor) depth only; the GT mesh and
    colour stay clean."""
    ds = office_dataset(n_images, image_size, pitch, extra_down_views)
    if depth_dropout > 0 or depth_noise > 0:
        clean = ds.depth_images
        ds.depth_images = corrupt_depth(clean, depth_dropout, depth_noise)
        ds.export_replica_format(workdir, scene="office")
        ds.depth_images = clean
    else:
        ds.export_replica_format(workdir, scene="office")
    fit_scene_vf_init(ds, os.path.join(workdir, "Replica", "office",
                                       "office.pkl"),
                      device=device, vf_config=vf_config)
    return ds


# ------------------------------------------------------------ mesh scoring
def run_quadrant_mc(config, resolution, num_quadrants, eval_root,
                    variants):
    """Quadrant marching cubes of the run's ``config.checkpoint`` at
    ``resolution`` with ``num_quadrants`` octants, for each of ``variants``
    (``plain``, ``smoothed``, ``smoothed-after``); returns the eval folder
    holding the merged-mesh-* folders."""
    from vf_nerf_torch.config.parser import config_device
    from vf_nerf_torch.datasets import dataset_dict
    from vf_nerf_torch.evaluation import methods
    from vf_nerf_torch.models.nerf import VectorFieldNerf
    from vf_nerf_torch.utils import io as io_utils

    path_to_model = os.path.join(config.exps_folder, config.expname,
                                 config.timestamp, "checkpoints", "vf_nerf",
                                 f"{config.checkpoint}.ckpt")
    config.vf_nerf_config.ray_sampler_config.perturb = False
    config.vf_nerf_config.dir_to_normal_th = -0.2
    model = VectorFieldNerf(config.vf_nerf_config,
                            device=config_device(config))
    model.load(path_to_model)
    model.eval()

    eval_folder = os.path.join(eval_root, config.expname,
                               f"{config.timestamp}_{config.checkpoint}")
    io_utils.mkdir_ifnotexists(eval_folder)
    dataset = dataset_dict[config.dataset_config.dataset_name](
        config.dataset_config)
    for variant in variants:
        methods.quadrant_marching_cubes(
            model, resolution,
            os.path.join(eval_folder, MC_FOLDERS[variant]),
            config.checkpoint, scale=dataset.scale, max_batch=100000,
            centroid=dataset.get_centroid(), num_quadrants=num_quadrants,
            smooth_after=(variant == "smoothed-after"),
            smooth_all=(variant == "smoothed"))
    return eval_folder


def score_mc_meshes(eval_folder, workdir, checkpoint="latest",
                    distance_thresh=0.05, n_samples=None):
    """Chamfer and precision / recall / F-score of each merged MC mesh
    (world coordinates) against the office's GT mesh, on ``n_samples``
    surface samples of each (1 M, or ``VFNERF_3D_METRIC_SAMPLES`` as for
    the TSDF metrics)."""
    from vf_nerf_torch.evaluation.methods import _metric_sample_count
    from vf_nerf_torch.utils.meshes import (chamfer_distance, nn_distances,
                                            precision_recall_fscore,
                                            sample_surface)
    from vf_nerf_torch.utils.ply import load_ply

    n_samples = _metric_sample_count(n_samples)
    gt_v, gt_f = load_ply(os.path.join(workdir, "Replica",
                                       "office_mesh.ply"))
    gt_pts = sample_surface(gt_v, gt_f, n_samples, seed=0)
    out = {}
    for variant in MC_FOLDERS.values():
        path = os.path.join(eval_folder, variant,
                            f"merged-mesh-scaled-{checkpoint}.ply")
        if not os.path.exists(path):
            continue
        v, f = load_ply(path)
        if not len(v):
            out[variant] = {"error": "empty mesh"}
            continue
        pred = sample_surface(v, f, n_samples, seed=0)
        dists = nn_distances(pred, gt_pts)
        entry = {"chamfer distance":
                 chamfer_distance(pred, gt_pts, distances=dists)}
        entry.update(precision_recall_fscore(pred, gt_pts, distance_thresh,
                                             distances=dists))
        entry["n_vertices"] = int(len(v))
        out[variant] = entry
    return out


# ------------------------------------------------------- image breakdowns
def _psnr(total, count):
    import numpy as np

    if count == 0:
        return None
    return float(-10.0 * np.log10(max(total / count, 1e-12)))


def edge_breakdown_ds(ds, img_dir: str):
    """Edge vs interior PSNR of the rendered views: the edge mask is the GT
    depth gradient's magnitude above 0.05, dilated by one pixel; sums are
    pixel-weighted over all views."""
    import numpy as np

    from vf_nerf_torch.utils import io as io_utils

    h, w = ds.image_size
    edge_sum = interior_sum = 0.0
    edge_cnt = interior_cnt = 0
    for i in range(ds.n_images):
        gt = ds.rgb_images[i].reshape(h, w, 3)
        depth = ds.depth_images[i].reshape(h, w)
        gy, gx = np.gradient(depth)
        edge = np.sqrt(gx ** 2 + gy ** 2) > 0.05
        edge = (np.pad(edge, 1)[:-2, 1:-1] | np.pad(edge, 1)[2:, 1:-1] |
                np.pad(edge, 1)[1:-1, :-2] | np.pad(edge, 1)[1:-1, 2:] |
                edge)
        pred = io_utils.load_rgb(os.path.join(img_dir, f"image-{i}.png"),
                                 transpose=False)
        sq = ((pred - gt) ** 2).mean(axis=-1)
        edge_sum += float(sq[edge].sum())
        edge_cnt += int(edge.sum())
        interior_sum += float(sq[~edge].sum())
        interior_cnt += int((~edge).sum())
    return {"edge_psnr": _psnr(edge_sum, edge_cnt),
            "interior_psnr": _psnr(interior_sum, interior_cnt),
            "edge_frac": edge_cnt / max(edge_cnt + interior_cnt, 1)}


def pixel_groups(ds):
    """Per view, the surface group each pixel's ray hits first."""
    import numpy as np

    from vf_nerf_torch.datasets.base import pixel_grid
    from vf_nerf_torch.datasets.synthetic import trace_rects

    h, w = ds.image_size
    uv = pixel_grid(h, w)
    fx, fy = ds.intrinsics[0, 0], ds.intrinsics[1, 1]
    cx, cy = ds.intrinsics[0, 2], ds.intrinsics[1, 2]
    dirs_cam = np.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy,
                         np.ones(h * w)], axis=-1)
    for pose in ds.poses:
        yield trace_rects(pose[:3, 3][None], dirs_cam @ pose[:3, :3].T,
                          ds.rects)[1]


def group_psnr_breakdown(ds, img_dir):
    """PSNR per object group (walls / floor / ceiling / corner block /
    column / thin wall / desk) over all views, with each group's share of
    the pixels."""
    import numpy as np

    from vf_nerf_torch.utils import io as io_utils

    h, w = ds.image_size
    sums = np.zeros(len(GROUPS))
    cnts = np.zeros(len(GROUPS), np.int64)
    for i, group in enumerate(pixel_groups(ds)):
        gt = ds.rgb_images[i].reshape(h, w, 3)
        pred = io_utils.load_rgb(os.path.join(img_dir, f"image-{i}.png"),
                                 transpose=False)
        sq = ((pred - gt) ** 2).mean(axis=-1).reshape(-1)
        for g in range(len(GROUPS)):
            m = group == g
            sums[g] += float(sq[m].sum())
            cnts[g] += int(m.sum())
    return {name: {"psnr": _psnr(sums[g], cnts[g]),
                   "pixel_frac": float(cnts[g] / cnts.sum())}
            for g, name in enumerate(GROUPS) if cnts[g]}


# ------------------------------------------------------------------ device
def device_record(gpu: str) -> str:
    """The card's ``nvidia-smi`` name and power limit, or ``cpu``."""
    if gpu == "cpu":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


class Stage:
    """Wall seconds and, on CUDA, peak device memory (GB) of a stage,
    synchronized at both ends."""

    def __init__(self, name, timings, peaks, cuda):
        self.name, self.timings, self.peaks = name, timings, peaks
        self.cuda = cuda

    def __enter__(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        if exc[0] is not None:
            return False
        if self.cuda:
            torch.cuda.synchronize()
            self.peaks[self.name] = torch.cuda.max_memory_allocated() / 1e9
        self.timings[self.name] = round(time.perf_counter() - self.t0, 1)
        return False


def epoch_losses(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [line["loss"] for line in map(json.loads, f)
                if line.get("_type") == "metrics"]


# -------------------------------------------------------------------- main
def argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--views", type=int, default=24)
    parser.add_argument("--size", type=int, nargs=2, default=[240, 320])
    parser.add_argument("--pitch", type=float, default=1.1)
    parser.add_argument("--epochs", type=int, default=2000)
    parser.add_argument("--resolution", type=int, default=256,
                        help="MC grid resolution (the reference evaluates "
                             "at 256 with 8 quadrants; the thin wall is ~2 "
                             "voxels at 128)")
    parser.add_argument("--workdir", type=str,
                        default=os.path.join(REPO, "build", "office"))
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--mc", type=str, default="plain",
                        choices=("none", "plain", "trio"),
                        help="quadrant-MC variants to extract and score: "
                             "'trio' = plain, smoothed and smoothed-after; "
                             "'plain' = the raw mesh only; 'none' = skip")
    parser.add_argument("--quadrants", type=int, default=8)
    parser.add_argument("--down-views", type=int, default=0,
                        help="extra views aimed down at the desk top")
    parser.add_argument("--depth-dropout", type=float, default=0.0,
                        help="sensor-hole probability applied to the "
                             "exported depth maps")
    parser.add_argument("--depth-noise", type=float, default=0.0,
                        help="Gaussian depth-noise sigma in scene units")
    parser.add_argument("--mask-invalid", action="store_true",
                        help="arm loss.config.mask_invalid_depth (exclude "
                             "zero-depth pixels from the depth loss)")
    parser.add_argument("--depth-clamp", type=float, default=None,
                        help="override loss.config.depth_loss_clamp "
                             "(shipped 0.5)")
    parser.add_argument("--gpu", type=str, default="auto",
                        help="'cpu' runs on the CPU; any other value on "
                             "CUDA")
    return parser


def main(argv=None) -> dict:
    args = argparser().parse_args(argv)
    args.workdir = os.path.abspath(args.workdir)
    import torch

    from vf_nerf_torch.config.parser import parse_config
    from vf_nerf_torch.evaluation.evaluate import evaluate
    from vf_nerf_torch.models.nerf import resolve_device
    from vf_nerf_torch.train.runner import VectorFieldNerfRunner

    device = "cpu" if args.gpu == "cpu" else "cuda"
    resolve_device(device)            # raises without CUDA
    cuda = device != "cpu"

    if os.path.exists(args.workdir):
        shutil.rmtree(args.workdir)
    os.makedirs(args.workdir)
    conf_path = write_conf(args.workdir, args.epochs)
    if args.depth_clamp is not None:
        apply_depth_clamp(conf_path, args.depth_clamp)
    if args.mask_invalid:
        apply_mask_invalid_depth(conf_path)
    vf_config = parse_config(scene="office", config_path=conf_path,
                             gpu=args.gpu).vf_nerf_config.vf_net_config

    total_views = args.views + args.down_views
    print(f"== exporting office ({args.views} ring + {args.down_views} "
          f"desk-task views @ {args.size}) + generic vf-init ==", flush=True)
    timings, peaks = {}, {}
    with Stage("export", timings, peaks, cuda):
        ds = export_office(args.workdir, args.views, tuple(args.size),
                           args.pitch, depth_dropout=args.depth_dropout,
                           depth_noise=args.depth_noise,
                           extra_down_views=args.down_views, device=device,
                           vf_config=vf_config)

    print(f"== training seed {args.seed} ({args.epochs} epochs x "
          f"{total_views} steps) ==", flush=True)
    # Read when the runner is built.
    os.environ["VFNERF_SEED"] = str(args.seed)
    with Stage("train", timings, peaks, cuda):
        config = parse_config(scene="office", config_path=conf_path,
                              gpu=args.gpu, expname="office",
                              timestamp="run", data_root_dir=args.workdir,
                              offline=True)
        runner = VectorFieldNerfRunner(config)
        runner.train()
    train_s = timings.pop("train")
    final_loss = runner.final_loss
    fine_samples = runner.model.fine_n_samples
    losses = epoch_losses(runner.run_dir)
    with open(os.path.join(runner.run_dir, "convergence.json")) as f:
        convergence = json.load(f)
    del runner
    if cuda:
        torch.cuda.empty_cache()
    print(f"train wall: {train_s:.0f}s  final loss: {final_loss}",
          flush=True)

    def eval_config():
        return parse_config(scene="office", config_path=conf_path,
                            gpu=args.gpu, expname="office", timestamp="run",
                            checkpoint="latest",
                            data_root_dir=args.workdir, offline=True)

    del timings["export"]
    eval_root = os.path.join(args.workdir, "evals")
    for method in ("metrics", "3d-metrics"):
        with Stage(method, timings, peaks, cuda):
            evaluate(eval_config(), method=method,
                     resolution=args.resolution, eval_root_folder=eval_root,
                     chunk_size=1024, distance_thresh=0.05, num_quadrants=8)
        print(f"{method}: {timings[method]}s", flush=True)

    mc_metrics = None
    if args.mc != "none":
        variants = (("plain",) if args.mc == "plain" else
                    ("plain", "smoothed", "smoothed-after"))
        with Stage("quadrant-mc", timings, peaks, cuda):
            eval_folder = run_quadrant_mc(eval_config(), args.resolution,
                                          args.quadrants, eval_root,
                                          variants)
        with Stage("mc-metrics", timings, peaks, cuda):
            mc_metrics = score_mc_meshes(eval_folder, args.workdir)
        print(f"quadrant-mc: {timings['quadrant-mc']}s, scoring: "
              f"{timings['mc-metrics']}s", flush=True)

    out_dir = os.path.join(eval_root, "office_office", "run_latest")
    with open(os.path.join(out_dir, "metrics.json")) as f:
        metrics = json.load(f)
    with open(os.path.join(out_dir, "3d-metrics.json")) as f:
        m3d = json.load(f)
    img_dir = os.path.join(out_dir, "rendered_images")
    summary = {
        "note": ("full protocol on the non-convex synthetic office "
                 "(tools/torch_office_protocol.py, vf_nerf_torch): "
                 "L-shaped room + column + thin free-standing wall + desk, "
                 "per-object textures, generic exterior_scene VF init"),
        "views": total_views, "ring_views": args.views,
        "down_views": args.down_views, "image_size": list(args.size),
        "epochs": args.epochs, "seed": args.seed,
        "depth_loss_clamp": (0.5 if args.depth_clamp is None
                             else args.depth_clamp),
        "depth_dropout": args.depth_dropout,
        "depth_noise_sigma": args.depth_noise,
        "mask_invalid_depth": args.mask_invalid,
        "mc_resolution": args.resolution,
        "train_wall_s": train_s,
        "train_rays_per_sec": round(
            args.epochs * total_views * 1024 / train_s, 1),
        "final_epoch_loss": final_loss,
        "mean_psnr": metrics["mean_psnr"],
        "per_image_psnr": {k: v["psnr"] for k, v in metrics.items()
                           if k.startswith("image-")},
        "edge_breakdown": edge_breakdown_ds(ds, img_dir),
        "group_psnr": group_psnr_breakdown(ds, img_dir),
        "metrics_3d": m3d,
        "eval_wall_s": timings,
        "device": device_record(args.gpu),
        "peak_memory_gb": peaks,
        "convergence": convergence,
        "fine_samples": fine_samples,
        "epoch_losses": losses,
    }
    if mc_metrics is not None:
        summary["mc"] = {"resolution": args.resolution,
                         "num_quadrants": args.quadrants,
                         "metrics_3d_mc": mc_metrics}
    with open(os.path.join(args.workdir, "office.json"), "w") as f:
        json.dump(summary, f, indent=1)
    brief = {k: summary[k] for k in ("mean_psnr", "train_wall_s")}
    brief["fscore_tsdf"] = m3d.get("tsdf", {}).get("fscore")
    print("OFFICE_SUMMARY " + json.dumps(brief), flush=True)
    print(f"full summary: {os.path.join(args.workdir, 'office.json')}")
    return summary


if __name__ == "__main__":
    main()
