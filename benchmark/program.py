"""The system under test: ``vf_nerf_torch`` built from a configuration file,
a scene and weights that the benchmark made.

The benchmark takes from the program only its runner and facade, their
entry points (``VectorFieldNerfRunner.train_epoch``,
``VectorFieldNerf.render_image``) and, for the checked steps, what those
hand each other: the packed ray batch and the generator a step draws from
(``make_train_step``'s documented draws).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from benchmark.plain.vfnerf import colour_widths, layer_names, vf_widths


# ------------------------------------------------------------------ weights
def weight_names(conf: dict) -> List[str]:
    vf, rn = conf["vector_field_network"], conf["rendering"]
    return (layer_names("vf.", vf_widths(vf), vf["batch_norm"]) +
            layer_names("render.", colour_widths(rn), rn["batch_norm"]) +
            [f"density.{k}" for k in ("beta", "scale", "mean")])


def make_weights(conf: dict, seed: int, device, vf_gain: float
                 ) -> Dict[str, torch.Tensor]:
    """Every tensor of both nets from one uniform draw on the device:
    Linear weights and biases U(±1/√fan_in) (the VF net's weights × vf_gain,
    so that the seeded field turns along the rays), BatchNorm scale
    U(0.75, 1.25), shift and running mean U(±0.1), running variance
    U(0.75, 1.25); the density scalars at the conf's initial values. The
    running statistics are then set by ``calibrate_batch_norm``."""
    vf, rn = conf["vector_field_network"], conf["rendering"]
    shapes = []
    for prefix, widths, bn in (("vf.", vf_widths(vf), vf["batch_norm"]),
                               ("render.", colour_widths(rn),
                                rn["batch_norm"])):
        for i, (fan_in, fan_out) in enumerate(widths):
            bound = 1.0 / math.sqrt(fan_in)
            gain = vf_gain if prefix == "vf." else 1.0
            with_bn = bn and i < len(widths) - 1
            base = f"{prefix}layers.{i}." + ("0." if with_bn else "")
            shapes.append((base + "weight", (fan_out, fan_in), -bound * gain,
                           bound * gain))
            shapes.append((base + "bias", (fan_out,), -bound, bound))
            if with_bn:
                b = f"{prefix}layers.{i}.1."
                shapes += [(b + "weight", (fan_out,), 0.75, 1.25),
                           (b + "bias", (fan_out,), -0.1, 0.1),
                           (b + "running_mean", (fan_out,), -0.1, 0.1),
                           (b + "running_var", (fan_out,), 0.75, 1.25)]
    total = sum(math.prod(s) for _, s, _, _ in shapes)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, lo, hi in shapes:
        n = math.prod(shape)
        out[name] = (flat[at:at + n] * (hi - lo) + lo).reshape(shape)
        at += n
    init = conf["density"]["params_init"]
    for k in ("beta", "scale", "mean"):
        out[f"density.{k}"] = torch.tensor(float(init[k]), device=device)
    return out


def calibrate_batch_norm(conf: dict, weights: Dict[str, torch.Tensor],
                         scene: dict, seed: int, n_points: int = 65536
                         ) -> None:
    """Set each BatchNorm's running statistics to the batch statistics of
    points the scene's rays reach, as training leaves them: ``n_points``
    points at uniform depths in [near, far] on rays through random pixels
    of random views, their view directions, and the VF net's outputs there
    for the colour net. Without it the nets' layers would keep the seeded
    scale, and the VF net's gain would compound over its layers into a
    field that flips on rounding."""
    from benchmark.plain import vfnerf as ref
    dev = scene["poses"].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand((n_points, 4), generator=gen, device=dev)
    h, w = scene["size"]
    view = (u[:, 0] * len(scene["poses"])).long().clamp(
        max=len(scene["poses"]) - 1)
    uv = torch.stack([(u[:, 1] * w).floor(), (u[:, 2] * h).floor()], 1)
    d, ud, o = ref.rays(uv, scene["poses"][view],
                        scene["intrinsics"].expand(n_points, 4, 4))
    pts = o + (scene["near"] + u[:, 3:] * (scene["far"] - scene["near"])) * d
    model = ref.Model(conf)
    with torch.no_grad(), ref.precision(False):
        vf_stats, rn_stats = {}, {}
        out = model.vf(weights, pts, True, vf_stats)
        model.colour(weights, pts, out[:, :3], ud, out[:, 3:3 + model.feat],
                     True, rn_stats)
    for net, stats in (("vf", vf_stats), ("render", rn_stats)):
        for i, (mean, var) in stats.items():
            weights[f"{net}.layers.{i}.1.running_mean"] = mean
            weights[f"{net}.layers.{i}.1.running_var"] = var


def load_weights(modules, weights: Dict[str, torch.Tensor]) -> None:
    """Copy the weights into the program's modules (``vf``, ``render``,
    ``density``) by state-dict name."""
    with torch.no_grad():
        states = {k: getattr(modules, k).state_dict()
                  for k in ("vf", "render", "density")}
        for name, value in weights.items():
            net, key = name.split(".", 1)
            states[net][key].copy_(value)


# ------------------------------------------------------------------- config
def program_config(conf: dict, exps_folder: str, device: str):
    """The program's runner config from a configuration file's sections
    (the dataset is the traffic's; logs go under ``exps_folder``)."""
    from vf_nerf_torch.config import schema as s
    dev = dict(conf.get("device", {}))
    dev["platform"] = "cpu" if device == "cpu" else ""
    vf_nerf = s.VFNerfConfig(
        s.VFNetConfig(**conf["vector_field_network"]),
        s.RenderingNetConfig(**conf["rendering"]),
        s.RaySamplerConfig(**conf["ray_sampler"]),
        s.DeviceConfig(**dev),
        s.SchedulerConfig(**conf["scheduler"]),
        s.DensityConfig(**conf["density"]),
        **conf["vf_nerf"])
    dataset = s.DatasetConfig(**dict(conf["dataset"],
                                     dataset_name="synthetic_office"),
                              scene="office", data_root_dir="")
    train = dict(conf["train"], exps_folder=exps_folder)
    return s.VFRunnerConfig(
        dataset, vf_nerf, s.VFLossWeights(**conf["loss"]["weights"]),
        s.VFLossConfig(**conf["loss"]["config"]), **train,
        timestamp="bench", checkpoint="", expname="bench", offline=True,
        config_path="")


def office(scene: dict, seed: int, pixels_per_batch: int,
           shuffle_views: bool):
    """The synthetic office (an L-shaped room with a column, a thin wall and
    a desk) seen from ``n_views`` cameras drawn from ``seed``."""
    from vf_nerf_torch.datasets.synthetic import SyntheticOfficeDataset
    return SyntheticOfficeDataset(
        n_images=scene["n_views"], image_size=tuple(scene["image_size"]),
        pitch_range=scene["pitch_range"], seed=seed,
        pixels_per_batch=pixels_per_batch, shuffle_views=shuffle_views)


def scene_arrays(ds, device) -> dict:
    """The scene as the benchmark hands it to the reference: images, depth,
    poses, intrinsics, on the device, and the bounds the method takes from
    the depth (near 0, far 1.25 × the deepest pixel)."""
    return {"rgb": torch.as_tensor(ds.rgb_images).to(device),
            "depth": torch.as_tensor(ds.depth_images).to(device),
            "poses": torch.as_tensor(ds.poses).to(device),
            "intrinsics": torch.as_tensor(ds.intrinsics).to(device),
            "size": tuple(ds.image_size),
            "near": 0.0,
            "far": float(np.float32(float(ds.depth_images.max()) * 1.25))}


def pixel_grid(h: int, w: int) -> np.ndarray:
    """(H·W, 2) float32 (x, y) pixel coordinates, row-major."""
    ys, xs = np.mgrid[0:h, 0:w]
    return np.stack([xs, ys], axis=-1).reshape(-1, 2).astype(np.float32)


def tmp_dir(what: str) -> str:
    """A directory for the program's logs under the run's ``TMPDIR``."""
    import tempfile
    return tempfile.mkdtemp(prefix=f"bench_{what}_")


def static_padding(conf: dict) -> bool:
    """Whether the program pads the fine axis to ``max_samples``: static
    fine growth, fine sampling on, the directional-derivative loss off."""
    return bool(conf.get("device", {}).get("static_fine_growth", False) and
                conf["ray_sampler"]["n_importance"] > 0 and
                conf["loss"]["weights"]["directional_derivatives"] == 0.0)


def train_bn(conf: dict) -> bool:
    """BatchNorm on batch statistics: the directional-derivative loss on
    and the analytic Jacobian (the numerical one keeps it frozen)."""
    return conf["loss"]["weights"]["directional_derivatives"] != 0.0 and \
        not conf["vf_nerf"].get("numerical_jacobian", False)


# The program's packed batch, (R, 38) float32 per step.
PACK = {"uv": (0, 2), "rgb": (2, 5), "depth": (5, 6), "intrinsics": (6, 22),
        "pose": (22, 38)}


def unpack(packed: torch.Tensor) -> Dict[str, torch.Tensor]:
    n = packed.shape[0]
    out = {k: packed[:, a:b] for k, (a, b) in PACK.items()}
    out["intrinsics"] = out["intrinsics"].reshape(n, 4, 4)
    out["pose"] = out["pose"].reshape(n, 4, 4)
    return out


def rays_from_scene(packed: torch.Tensor, scene: dict):
    """The batch as the reference takes it: each row's view and pixel read
    from the program's batch, every value from the scene. Returns (batch,
    rows that disagree with the scene)."""
    b = unpack(packed)
    poses = scene["poses"]
    h, w = scene["size"]
    # Each row's view: the scene pose equal to the row's.
    diff = (b["pose"][:, None] - poses[None]).abs().flatten(2).amax(-1)
    view = torch.argmin(diff, dim=1)
    x, y = b["uv"][:, 0].long(), b["uv"][:, 1].long()
    pix = (y.clamp(0, h - 1) * w + x.clamp(0, w - 1))
    ref = {"uv": torch.stack([x, y], 1).to(torch.float32),
           "pose": poses[view],
           "intrinsics": scene["intrinsics"].expand(len(view), 4, 4),
           "rgb": scene["rgb"][view, pix],
           "depth": scene["depth"][view, pix]}
    off = torch.zeros(len(view), dtype=torch.bool, device=packed.device)
    for k in ref:
        off |= (ref[k] != b[k]).reshape(len(view), -1).any(1)
    return ref, int(off.sum())
