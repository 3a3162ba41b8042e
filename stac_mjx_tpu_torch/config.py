"""Config system: YAML composition + dataclass schema validation (port of
``stac_mjx_tpu/config.py``; the schema equals the JAX one field for field, so
a config embedded in an h5 artifact by either package loads in the other).

- a root config with a ``defaults`` list composes group files from
  ``<config_dir>/<group>/<name>.yaml`` (``stac``/``model`` groups + ``_self_``);
- overrides: ``group=name`` swaps a group file, ``a.b.c=value`` sets a dotted
  key (values YAML-parsed), ``+a.b=value`` adds a new key;
- the merged config is validated against the `Config` dataclass schema
  (unknown keys rejected, missing required keys reported).

PyYAML is imported only by the functions that read or write YAML, so
``config_from_dict`` and ``ConfigNode`` work where it is not installed.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterable, Optional

_MISSING = object()


@dataclass
class ModelConfig:
    """Body-model configuration."""

    MJCF_PATH: str
    FTOL: float
    ROOT_FTOL: float  # declared but unused, as in the reference
    LIMB_FTOL: float  # declared but unused, as in the reference
    N_ITERS: int
    N_ITER_Q: int
    KP_NAMES: Optional[list] = None
    KEYPOINT_MODEL_PAIRS: dict = field(default_factory=dict)
    KEYPOINT_INITIAL_OFFSETS: dict = field(default_factory=dict)
    ROOT_OPTIMIZATION_KEYPOINT: Any = _MISSING
    TRUNK_OPTIMIZATION_KEYPOINTS: list = field(default_factory=list)
    INDIVIDUAL_PART_OPTIMIZATION: Any = _MISSING
    KEYPOINT_COLOR_PAIRS: dict = field(default_factory=dict)
    SCALE_FACTOR: float = 1.0
    MOCAP_SCALE_FACTOR: float = 1.0
    SITES_TO_REGULARIZE: Optional[list] = None
    RENDER_FPS: int = 50
    N_SAMPLE_FRAMES: int = 100
    M_REG_COEF: float = 1.0
    MARKER_SIZE: float = 0.005
    KP_NAMES_LABEL3D_PATH: Optional[str] = None


@dataclass
class MujocoConfig:
    """MuJoCo solver options (kept for config-file compatibility)."""

    solver: str = "newton"
    iterations: int = 1
    ls_iterations: int = 4


@dataclass
class StacConfig:
    """Pipeline configuration. The fields after ``mujoco`` are the JAX
    package's extensions; their meaning is documented there. In this port
    ``spd_impl`` is accepted and has no effect (on the card the flat LM
    always solves through the CUDA kernel), and ``wire_dtype`` must stay
    "float32", ``gn_stall_iters`` 0; ``ik_chunk_clips``, ``seq_segment_frames``
    and ``mesh_axis`` are accepted and not used."""

    fit_offsets_path: str
    ik_only_path: str
    data_path: str
    n_fit_frames: int
    skip_fit_offsets: bool = False
    skip_ik_only: bool = False
    infer_qvels: bool = False
    n_frames_per_clip: int = 1
    num_clips: int = 1
    continuous: bool = False
    mujoco: MujocoConfig = field(default_factory=MujocoConfig)
    pose_mode: str = "sequential"  # "sequential" | "lockstep"
    q_solver: str = "pg"  # "pg" | "pg-jaxopt" | "gn" | "gn-lm"
    skip_part_opt: bool = False
    fk_impl: str = "scan"  # "scan" | "jump"
    spd_impl: str = "auto"
    gn_stall_iters: int = 0
    gn_damping_rule: str = "nielsen"  # "nielsen" | "fixed"
    gn_iters: int = 0  # 0 = auto: min(N_ITER_Q, 14)
    ik_hier_stride: int = 0  # 0/1 = flat ik schedule
    ik_hier_fine_iters: int = 0
    fit_warm_iters: int = 0
    mesh_axis: Optional[int] = None
    ik_return_full: bool = True
    fit_return_full: bool = True
    ik_chunk_clips: int = 0
    seq_segment_frames: int = 0
    root_opt_passes: int = 0  # 0 = auto: 2 sequential, 1 lockstep
    part_opt_mode: str = "auto"  # "auto" | "sequential" | "batched"
    wire_dtype: str = "float32"


@dataclass
class Config:
    """Combined model + stac configuration."""

    model: ModelConfig
    stac: StacConfig


class ConfigNode:
    """Dict wrapper with attribute access, `in`, and .get().

    Wraps the underlying dict by reference (no copy) so nested mutation
    (``cfg.stac.data_path = ...``) is visible through every view.
    """

    def __init__(self, data: dict):
        object.__setattr__(self, "_data", data)

    def __getattr__(self, key):
        try:
            v = self._data[key]
        except KeyError as e:
            raise AttributeError(key) from e
        return ConfigNode(v) if isinstance(v, dict) else v

    def __setattr__(self, key, value):
        self._data[key] = value

    def __getitem__(self, key):
        v = self._data[key]
        return ConfigNode(v) if isinstance(v, dict) else v

    def __contains__(self, key):
        return key in self._data

    def get(self, key, default=None):
        v = self._data.get(key, default)
        return ConfigNode(v) if isinstance(v, dict) else v

    def keys(self):
        return self._data.keys()

    def items(self):
        for k, v in self._data.items():
            yield k, (ConfigNode(v) if isinstance(v, dict) else v)

    def to_dict(self) -> dict:
        return _deepcopy_dict(self._data)

    def to_yaml(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    def __repr__(self):
        return f"ConfigNode({self._data!r})"


def _deepcopy_dict(d: dict) -> dict:
    out = {}
    for k, v in d.items():
        out[k] = _deepcopy_dict(v) if isinstance(v, dict) else v
    return out


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def _set_dotted(cfg: dict, dotted: str, value):
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node.setdefault(p, {})
        if not isinstance(node, dict):
            raise ValueError(f"Cannot set {dotted}: {p} is not a mapping")
    node[parts[-1]] = value


def _has_dotted(cfg: dict, dotted: str) -> bool:
    node = cfg
    for p in dotted.split("."):
        if not isinstance(node, dict) or p not in node:
            return False
        node = node[p]
    return True


def _schema_has(dotted: str) -> bool:
    """Whether a dotted key names a field of the structured schema.

    Descending into a free-form dict field (e.g. KEYPOINT_MODEL_PAIRS)
    always counts as known: those subtrees are schemaless by design.
    """
    node = Config
    nested = {"model": ModelConfig, "stac": StacConfig, "mujoco": MujocoConfig}
    for part in dotted.split("."):
        if not dataclasses.is_dataclass(node):
            return True
        if part not in _schema_fields(node):
            return False
        node = nested.get(part, dict)
    return True


def _load_yaml(path: Path) -> dict:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f)
    return data or {}


def _schema_fields(cls) -> dict:
    return {f.name: f for f in dataclasses.fields(cls)}


def _validate_tree(data: dict) -> list[str]:
    """Structured-merge style validation: unknown and missing keys."""
    problems = []
    for key in data:
        if key not in ("model", "stac"):
            problems.append(f"unknown key: {key}")
    for group, cls in (("model", ModelConfig), ("stac", StacConfig)):
        sub = data.get(group)
        if sub is None:
            problems.append(f"missing required group: {group}")
            continue
        fields = _schema_fields(cls)
        for key in sub:
            if key not in fields:
                problems.append(f"unknown key: {group}.{key}")
        for name, f in fields.items():
            required = f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING
            if name not in sub and required:
                problems.append(f"missing required key: {group}.{name}")
        if group == "stac" and isinstance(sub.get("mujoco"), dict):
            mfields = _schema_fields(MujocoConfig)
            for key in sub["mujoco"]:
                if key not in mfields:
                    problems.append(f"unknown key: stac.mujoco.{key}")
    return problems


def compose_config(
    config_path: Path | str,
    config_name: str = "config",
    overrides: Iterable[str] | None = None,
) -> ConfigNode:
    """Load, compose, override, and validate a config tree."""
    import yaml

    config_dir = Path(config_path).resolve()
    root = _load_yaml(config_dir / f"{config_name}.yaml")

    overrides = list(overrides or [])
    # Group overrides may replace defaults-list entries.
    group_overrides = {}
    kv_overrides = []
    for ov in overrides:
        if ov.startswith("hydra/"):
            continue  # logging-control overrides: no-ops here
        key, _, val = ov.partition("=")
        add = key.startswith("+")
        key = key.lstrip("+")
        if "." not in key and (config_dir / key / f"{val}.yaml").exists():
            group_overrides[key] = val
        else:
            kv_overrides.append((key, yaml.safe_load(val) if val != "" else None, add))

    cfg: dict = {}
    defaults = root.pop("defaults", None)
    if defaults:
        for entry in defaults:
            if entry == "_self_":
                cfg = _merge(cfg, root)
                continue
            if isinstance(entry, dict):
                [(group, name)] = entry.items()
                name = group_overrides.pop(group, name)
                cfg = _merge(cfg, {group: _load_yaml(config_dir / group / f"{name}.yaml")})
            else:
                cfg = _merge(cfg, _load_yaml(config_dir / f"{entry}.yaml"))
        if "_self_" not in defaults:
            cfg = _merge(cfg, root)
    else:
        cfg = root

    # Group overrides not present in the defaults list still apply.
    for group, name in group_overrides.items():
        cfg = _merge(cfg, {group: _load_yaml(config_dir / group / f"{name}.yaml")})

    for key, val, add in kv_overrides:
        # '+' on an existing key and a plain override of a key that is in
        # neither the composed config nor the schema are both rejected: that
        # typo-catching is the point of the prefix.
        present = _has_dotted(cfg, key)
        if add and present:
            raise ValueError(f"override '+{key}': key already exists; drop the '+' prefix")
        if not add and not present and not _schema_has(key):
            raise ValueError(
                f"override '{key}': unknown key (neither in the composed "
                f"config nor the schema); to add a new key use '+{key}=...'"
            )
        _set_dotted(cfg, key, val)

    problems = _validate_tree(cfg)
    if problems:
        raise ValueError("Config validation failed:\n  " + "\n  ".join(problems))
    return ConfigNode(cfg)


def config_from_dict(data: dict) -> ConfigNode:
    """Validate an already-composed dict (e.g. loaded from an output h5)."""
    problems = _validate_tree(data)
    if problems:
        raise ValueError("Config validation failed:\n  " + "\n  ".join(problems))
    return ConfigNode(data)
