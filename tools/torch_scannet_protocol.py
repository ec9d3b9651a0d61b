"""The full protocol through the ScanNet loader, on vf_nerf_torch.

The port's counterpart of ``tools/scannet_protocol.py``, with its CLI and
its ``scannet.json``: export a synthetic scene (the office by default,
``--scene-type box`` for the box) in ScanNet's layout with
``frame_stride = 40`` (so the loader's every-40th subsample keeps every
view), fit the generic VF init, train the shipped conf through the
``scannet`` loader (``crop_edge`` trim and principal-point shift, depth
PNGs in mm, the ``vh_clean`` GT mesh), then render, score PSNR and run
``3d-metrics``.

Runs on CUDA unless given ``--gpu cpu``; imports nothing of the JAX
package.

Usage: python tools/torch_scannet_protocol.py [--views 24] [--size 240 320]
       [--epochs 1500] [--crop 10] [--scene-type office]
       [--depth-clamp 3.0] [--workdir build/scannet] [--gpu cpu]
"""

import argparse
import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (REPO, os.path.join(REPO, "tools")):
    if path not in sys.path:
        sys.path.insert(0, path)

import torch_office_protocol as protocol  # noqa: E402
from torch_office_protocol import (Stage, apply_depth_clamp,  # noqa: E402
                                   device_record, epoch_losses,
                                   fit_scene_vf_init)


def write_scannet_conf(workdir: str, epochs: int, crop: int,
                       scene_type: str = "box",
                       depth_clamp: float = None) -> str:
    """``<workdir>/run.conf``: the shipped conf on the ``scannet`` loader
    with ``crop_edge = crop``, ``epochs`` epochs, a save every 500, static
    fine growth and the non-convergence gate at 1.2x the matching cohort's
    median final loss (box 0.00574; office 0.010 at clamp >= 3.0, else
    0.021)."""
    conf_path = os.path.join(workdir, "run.conf")
    with open(protocol.CONF) as f:
        conf = f.read()
    conf = conf.replace("num_epochs = 3001", f"num_epochs = {epochs}")
    conf = conf.replace("save_frequency = 100", "save_frequency = 500")
    conf = conf.replace('exps_folder = "./exps_vf_nerf"',
                        f'exps_folder = "{os.path.join(workdir, "exps")}"')
    conf = conf.replace('dataset_name = "replica"',
                        'dataset_name = "scannet"')
    conf = conf.replace('data_dir = "Replica"',
                        f'data_dir = "ScanNet"\n    crop_edge = {crop}')
    conf += "\ndevice { static_fine_growth = True }\n"
    if scene_type == "box":
        thr = 0.00574
    elif depth_clamp is not None and depth_clamp >= 3.0:
        thr = 0.010
    else:
        thr = 0.021
    conf += f"\ntrain {{ convergence_loss_threshold = {thr} }}\n"
    with open(conf_path, "w") as f:
        f.write(conf)
    if depth_clamp is not None:
        apply_depth_clamp(conf_path, depth_clamp)
    return conf_path


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--views", type=int, default=24)
    parser.add_argument("--size", type=int, nargs=2, default=[240, 320])
    parser.add_argument("--pitch", type=float, default=1.1)
    parser.add_argument("--epochs", type=int, default=1500)
    parser.add_argument("--crop", type=int, default=10,
                        help="crop_edge (reference default 10)")
    parser.add_argument("--resolution", type=int, default=128)
    parser.add_argument("--workdir", type=str,
                        default=os.path.join(REPO, "build", "scannet"))
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--scene-type", type=str, default="office",
                        choices=("box", "office"))
    parser.add_argument("--depth-clamp", type=float, default=None,
                        help="override loss.config.depth_loss_clamp")
    parser.add_argument("--gpu", type=str, default="auto",
                        help="'cpu' runs on the CPU; any other value on "
                             "CUDA")
    args = parser.parse_args(argv)
    args.workdir = os.path.abspath(args.workdir)

    from vf_nerf_torch.config.parser import parse_config
    from vf_nerf_torch.datasets.synthetic import (SyntheticBoxDataset,
                                                  SyntheticOfficeDataset)
    from vf_nerf_torch.evaluation.evaluate import evaluate
    from vf_nerf_torch.models.nerf import resolve_device
    from vf_nerf_torch.train.runner import VectorFieldNerfRunner

    device = "cpu" if args.gpu == "cpu" else "cuda"
    resolve_device(device)            # raises without CUDA
    cuda = device != "cpu"
    if os.path.exists(args.workdir):
        shutil.rmtree(args.workdir)
    os.makedirs(args.workdir)

    scene = "scene0000_00"
    print(f"== exporting {args.scene_type} scene as ScanNet/{scene} "
          f"({args.views} views @ {args.size}, frame_stride=40) ==",
          flush=True)
    ds_cls = (SyntheticOfficeDataset if args.scene_type == "office"
              else SyntheticBoxDataset)
    ds = ds_cls(n_images=args.views, image_size=tuple(args.size),
                pixels_per_batch=1024, pitch_range=args.pitch)
    base = ds.export_scannet_format(args.workdir, scene=scene,
                                    frame_stride=40)
    conf_path = write_scannet_conf(args.workdir, args.epochs, args.crop,
                                   args.scene_type, args.depth_clamp)
    vf_config = parse_config(scene=scene, config_path=conf_path,
                             gpu=args.gpu).vf_nerf_config.vf_net_config
    fit_scene_vf_init(ds, os.path.join(base, f"{scene}.pkl"), device=device,
                      vf_config=vf_config)

    print(f"== training seed {args.seed} ({args.epochs} epochs x "
          f"{args.views} steps, crop_edge={args.crop}) ==", flush=True)
    # Read when the runner is built.
    os.environ["VFNERF_SEED"] = str(args.seed)
    timings, peaks = {}, {}
    with Stage("train", timings, peaks, cuda):
        config = parse_config(scene=scene, config_path=conf_path,
                              gpu=args.gpu, expname="scannet",
                              timestamp="run", data_root_dir=args.workdir,
                              offline=True)
        runner = VectorFieldNerfRunner(config)
        if runner.dataset.n_images != args.views:
            raise RuntimeError(
                f"frame_stride export broken: loader saw "
                f"{runner.dataset.n_images} of {args.views} views")
        h_eff, w_eff = runner.dataset.image_size
        if (h_eff, w_eff) != (args.size[0] - 2 * args.crop,
                              args.size[1] - 2 * args.crop):
            raise RuntimeError(f"crop_edge {args.crop} gave frames of "
                               f"{h_eff} x {w_eff}")
        runner.train()
    train_s = timings["train"]
    final_loss = runner.final_loss
    with open(os.path.join(runner.run_dir, "convergence.json")) as f:
        convergence = json.load(f)
    losses = epoch_losses(runner.run_dir)
    del runner
    print(f"train wall: {train_s:.0f}s  final loss: {final_loss}",
          flush=True)

    eval_root = os.path.join(args.workdir, "evals")
    for method in ("metrics", "3d-metrics"):
        config2 = parse_config(scene=scene, config_path=conf_path,
                               gpu=args.gpu, expname="scannet",
                               timestamp="run", checkpoint="latest",
                               data_root_dir=args.workdir, offline=True)
        with Stage(method, timings, peaks, cuda):
            evaluate(config2, method=method, resolution=args.resolution,
                     eval_root_folder=eval_root, chunk_size=1024,
                     distance_thresh=0.05, num_quadrants=8)
        print(f"{method}: {timings[method]}s", flush=True)

    out_dir = os.path.join(eval_root, f"scannet_{scene}", "run_latest")
    with open(os.path.join(out_dir, "metrics.json")) as f:
        metrics = json.load(f)
    with open(os.path.join(out_dir, "3d-metrics.json")) as f:
        m3d = json.load(f)
    summary = {
        "note": ("full protocol through the ScanNet loader "
                 "(tools/torch_scannet_protocol.py, vf_nerf_torch): "
                 "frame_stride-40 export, crop_edge trim + principal-point "
                 "shift, mm depth PNGs, vh_clean GT mesh"),
        "scene_type": args.scene_type,
        "depth_loss_clamp": (0.5 if args.depth_clamp is None
                             else args.depth_clamp),
        "views": args.views, "image_size": list(args.size),
        "crop_edge": args.crop,
        "effective_image_size": [h_eff, w_eff],
        "epochs": args.epochs, "seed": args.seed,
        "mc_resolution": args.resolution,
        "train_wall_s": train_s,
        "train_rays_per_sec": round(
            args.epochs * args.views * 1024 / train_s, 1),
        "final_epoch_loss": final_loss,
        "mean_psnr": metrics["mean_psnr"],
        "metrics_3d": m3d,
        "eval_wall_s": {k: v for k, v in timings.items() if k != "train"},
        "device": device_record(args.gpu),
        "peak_memory_gb": peaks,
        "convergence": convergence,
        "epoch_losses": losses,
    }
    with open(os.path.join(args.workdir, "scannet.json"), "w") as f:
        json.dump(summary, f, indent=1)
    brief = {"mean_psnr": summary["mean_psnr"],
             "train_wall_s": summary["train_wall_s"],
             "fscore_tsdf": m3d.get("tsdf", {}).get("fscore")}
    print("SCANNET_SUMMARY " + json.dumps(brief), flush=True)
    print(f"full summary: {os.path.join(args.workdir, 'scannet.json')}")
    return summary


if __name__ == "__main__":
    main()
