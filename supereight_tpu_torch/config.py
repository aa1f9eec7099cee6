"""Run configuration: a copy of ``supereight_tpu/config.py``.

Mirrors the reference's Configuration struct + CLI defaults
(se_denseslam/include/se/config.h:39-214,
se_apps/include/default_parameters.h:25-49) so reference command lines
translate directly. Every flag and default is JAX's, so a command line of
the JAX package's CLI runs the port unchanged; ``--platform`` picks the
torch device (:func:`device_from_platform`) instead of JAX's platform.
"""

import argparse
import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class Configuration:
    # processing rates (frames)
    compute_size_ratio: int = 1
    tracking_rate: int = 1
    integration_rate: int = 2
    rendering_rate: int = 4

    # volume
    volume_resolution: int = 256
    volume_size: float = 2.0
    initial_pos_factor: Tuple[float, float, float] = (0.5, 0.5, 0.0)

    # pipeline
    pyramid: Tuple[int, ...] = (10, 5, 4)
    mu: float = 0.1
    icp_threshold: float = 1e-5
    # input filter: False/"" = none, True/"bilateral" = the reference's
    # -F 5x5 bilateral, "median" = 3x3 median (noise-grade option)
    filter_input: object = False

    # camera intrinsics fx, fy, cx, cy; None = guess from image size
    camera: Optional[Tuple[float, float, float, float]] = None

    # field type: "tsdf" | "ofusion"
    field: str = "tsdf"

    # fuse with bilinear inverse-depth filtering instead of
    # nearest-neighbour (the reference DEFINES interpDepth,
    # bfusion/mapping_impl.hpp:41-92, but its update functors read
    # depth[int(pixel)] — nearest is the parity default)
    depth_interp: bool = False

    # sigma(z)-scaled TSDF fusion weights (fields/tsdf.update
    # noise_weighted; off = reference's constant-1 weights)
    noise_weighted: bool = False

    # fuse the FILTERED depth instead of raw (noise-grade option; the
    # reference fuses raw — see parallel/step.py fuse_filtered)
    fuse_filtered: bool = False

    # drop ICP reference pixels whose hit voxel has fused fewer than
    # this many observations (0 = off, reference behavior)
    min_ref_weight: float = 0.0

    # io
    input_file: str = ""
    log_file: str = ""
    dump_volume_file: str = ""
    groundtruth_file: str = ""

    # capacity of the voxel-block pool; None = heuristic from resolution
    block_capacity: Optional[int] = None

    # floor for the integration budget and raycast pool bucket (0 =
    # adaptive doubling from the live block count)
    preset_budget: int = 0

    def resolve_capacity(self) -> int:
        if self.block_capacity is not None:
            return self.block_capacity
        b = self.volume_resolution // 8
        # surface-shell heuristic: ~6 faces of the block grid plus band
        # thickness headroom (the 250-frame loop room at 512^3 fuses
        # ~36k blocks and overflowed the old 8*b*b = 32k pool — r4)
        return min(b ** 3, max(16384, 12 * b * b))


def default_camera(width: int, height: int):
    """Reference fallback intrinsics: 481.2/-480/center (ICL-NUIM-flavored,
    ref default_parameters.h + interface.h:169-177)."""
    return (481.2 * width / 640.0, -480.0 * height / 480.0,
            width / 2.0, height / 2.0)


def build_parser() -> argparse.ArgumentParser:
    """CLI mirroring the reference getopt long options
    (default_parameters.h:195-466)."""
    p = argparse.ArgumentParser(prog="supereight-tpu-torch")
    p.add_argument("-c", "--compute-size-ratio", type=int, default=1)
    p.add_argument("-t", "--tracking-rate", type=int, default=1)
    p.add_argument("-r", "--integration-rate", type=int, default=2)
    p.add_argument("-z", "--rendering-rate", type=int, default=4)
    p.add_argument("-v", "--volume-resolution", type=int, default=256)
    p.add_argument("-s", "--volume-size", type=float, default=2.0)
    p.add_argument("-p", "--init-pose", type=str, default="0.5,0.5,0")
    p.add_argument("-y", "--pyramid-levels", type=str, default="10,5,4")
    p.add_argument("-m", "--mu", type=float, default=0.1)
    p.add_argument("-l", "--icp-threshold", type=float, default=1e-5)
    p.add_argument("-k", "--camera", type=str, default="")
    p.add_argument("-F", "--bilateral-filter", action="store_true")
    p.add_argument("--filter",
                   choices=["none", "bilateral", "median", "median2"],
                   default="",
                   help="input depth filter (--filter median is the "
                        "noise-grade option; -F = bilateral)")
    p.add_argument("--fuse-filtered", action="store_true",
                   help="integrate the filtered depth (noise-grade "
                        "deviation; reference fuses raw)")
    p.add_argument("--min-ref-weight", type=float, default=0.0,
                   help="ICP ignores reference pixels with map weight "
                        "below this (0 = off)")
    p.add_argument("--noise-weighted", action="store_true",
                   help="sigma(z)-scaled TSDF fusion weights for noisy "
                        "range sensors (deviation from the reference's "
                        "constant weights)")
    p.add_argument("-f", "--field", type=str, default="tsdf",
                   choices=["tsdf", "ofusion"])
    p.add_argument("-i", "--input-file", type=str, default="")
    p.add_argument("-o", "--log-file", type=str, default="")
    p.add_argument("-d", "--dump-volume", type=str, default="")
    p.add_argument("-g", "--groundtruth", type=str, default="")
    p.add_argument("--block-capacity", type=int, default=None)
    p.add_argument("--preset-budget", type=int, default=0)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--depth-interp", action="store_true",
                   help="bilinear inverse-depth fusion sampling "
                        "(reference interpDepth; off = reference parity)")
    p.add_argument("--platform", type=str, default=None,
                   help="torch device: 'cpu' runs on the CPU, anything "
                        "else (the default) on the CUDA card")
    return p


def device_from_platform(platform) -> str:
    """The torch device of ``--platform``: "cpu" asks for the CPU, and
    anything else, the default included, means the card ("cuda"), which
    raises on a host without one."""
    return "cpu" if platform == "cpu" else "cuda"


def config_from_args(args) -> Configuration:
    cam = None
    if args.camera:
        cam = tuple(float(x) for x in args.camera.split(","))
        assert len(cam) == 4
    return Configuration(
        compute_size_ratio=args.compute_size_ratio,
        tracking_rate=args.tracking_rate,
        integration_rate=args.integration_rate,
        rendering_rate=args.rendering_rate,
        volume_resolution=args.volume_resolution,
        volume_size=args.volume_size,
        initial_pos_factor=tuple(
            float(x) for x in args.init_pose.split(",")),
        pyramid=tuple(int(x) for x in args.pyramid_levels.split(",")),
        mu=args.mu,
        icp_threshold=args.icp_threshold,
        filter_input=(args.filter if args.filter and args.filter != "none"
                      else args.bilateral_filter),
        noise_weighted=args.noise_weighted,
        fuse_filtered=args.fuse_filtered,
        min_ref_weight=args.min_ref_weight,
        camera=cam,
        field=args.field,
        depth_interp=args.depth_interp,
        input_file=args.input_file,
        log_file=args.log_file,
        dump_volume_file=args.dump_volume,
        groundtruth_file=args.groundtruth,
        block_capacity=args.block_capacity,
        preset_budget=args.preset_budget,
    )
