"""Scene-configuration (.scf) file reader: a copy of
``supereight_tpu/io/scf.py`` over the port's ``config.Configuration``.

Behavioral reference: se_apps reader (reader.cpp:22-159) — a key=value
file that can override volume geometry, camera intrinsics, and input
settings of a run.
"""

from supereight_tpu_torch.config import Configuration

_KEYS = {
    "volume_resolution": ("volume_resolution", int),
    "volume_size": ("volume_size", float),
    "compute_size_ratio": ("compute_size_ratio", int),
    "integration_rate": ("integration_rate", int),
    "tracking_rate": ("tracking_rate", int),
    "rendering_rate": ("rendering_rate", int),
    "mu": ("mu", float),
    "icp_threshold": ("icp_threshold", float),
    "field": ("field", str),
    "input_file": ("input_file", str),
    "log_file": ("log_file", str),
    "groundtruth_file": ("groundtruth_file", str),
    "dump_volume_file": ("dump_volume_file", str),
}


def parse_scf(path, base: Configuration = None) -> Configuration:
    cfg = base or Configuration()
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, val = (s.strip() for s in line.split("=", 1))
            if key == "camera":
                cfg.camera = tuple(float(x) for x in val.split(","))
            elif key == "pyramid":
                cfg.pyramid = tuple(int(x) for x in val.split(","))
            elif key == "initial_pos_factor":
                cfg.initial_pos_factor = tuple(
                    float(x) for x in val.split(","))
            elif key in _KEYS:
                attr, typ = _KEYS[key]
                setattr(cfg, attr, typ(val))
    return cfg
