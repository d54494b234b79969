"""Configuration dataclasses and the YAML entry point.

The same field names and defaults as the JAX package's ``config.py`` for
what this package runs: the EGNN denoiser, the diffusion schedule, the
model's feature sizes, and unguided sampling.  Reference-style YAML files
(``configs/*.yml``, a checkpoint's ``hparams.yaml``) are read by a small
parser for the subset of YAML those files use, so the package needs no
YAML library.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional, Sequence


@dataclass(frozen=True)
class EGNNConfig:
    """EGNN denoiser (reference egnn_params)."""
    joint_nf: int = 128
    hidden_nf: int = 256
    n_layers: int = 6
    inv_sublayers: int = 1
    attention: bool = True
    tanh: bool = True
    coords_range: float = 15.0
    norm_constant: float = 1.0
    sin_embedding: bool = False
    normalization_factor: float = 100.0
    aggregation_method: str = "sum"
    reflection_equivariant: bool = False
    edge_cutoff_ligand: Optional[float] = None
    edge_cutoff_pocket: Optional[float] = 5.0
    edge_cutoff_interaction: Optional[float] = 5.0
    edge_embedding_dim: Optional[int] = None
    update_pocket_coords: bool = False  # conditional mode freezes the pocket
    condition_time: bool = True


@dataclass(frozen=True)
class DiffusionConfig:
    """Reference diffusion_params."""
    timesteps: int = 500
    noise_schedule: str = "polynomial_2"
    noise_precision: float = 5.0e-4
    norm_values: Sequence[float] = (1.0, 4.0)
    norm_biases: Sequence[float] = (0.0, 0.0)


@dataclass(frozen=True)
class ModelConfig:
    dataset: str = "crossdock_full"
    mode: str = "pocket_conditioning"
    pocket_representation: str = "full-atom"
    atom_nf: int = 10
    residue_nf: int = 10
    n_dims: int = 3
    egnn: EGNNConfig = field(default_factory=EGNNConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)


@dataclass(frozen=True)
class SampleConfig:
    """Unguided sampling settings: the padding buckets."""
    lig_pad_multiple: int = 8
    pocket_pad_multiple: int = 64


# ---------------------------------------------------------------------------
# YAML subset: nested block mappings, inline [a, b] lists, block "- x"
# lists, comments, quoted strings; scalars resolve like yaml.safe_load
# (a float needs a dot, so "1e-3" stays a string there too)
# ---------------------------------------------------------------------------

_INT = re.compile(r"^[-+]?[0-9]+$")
_FLOAT = re.compile(r"^[-+]?([0-9][0-9_]*)?\.[0-9.]*([eE][-+][0-9]+)?$")


def _scalar(text: str):
    text = text.strip()
    if text[:1] in ("'", '"') and text[-1:] == text[:1]:
        return text[1:-1]
    if text.startswith("[") and text.endswith("]"):
        inner = text[1:-1].strip()
        return [_scalar(v) for v in inner.split(",")] if inner else []
    low = text.lower()
    if low in ("null", "~", ""):
        return None
    if low == "true":
        return True
    if low == "false":
        return False
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text) and text not in (".", "+.", "-."):
        return float(text.replace("_", ""))
    return text


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in ("'", '"'):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_yaml(text: str) -> dict:
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if line.strip():
            lines.append((len(line) - len(line.lstrip(" ")), line.strip()))

    def block(i: int, indent: int):
        """Parse the block starting at lines[i] with this indent."""
        if lines[i][1].startswith("- "):
            out = []
            while i < len(lines) and lines[i][0] == indent \
                    and lines[i][1].startswith("- "):
                out.append(_scalar(lines[i][1][2:]))
                i += 1
            return out, i
        out = {}
        while i < len(lines) and lines[i][0] == indent:
            key, _, rest = lines[i][1].partition(":")
            i += 1
            if rest.strip():
                out[key.strip()] = _scalar(rest)
            elif i < len(lines) and (lines[i][0] > indent or (
                    lines[i][0] == indent and lines[i][1].startswith("- "))):
                out[key.strip()], i = block(i, lines[i][0])
            else:
                out[key.strip()] = None
        return out, i

    if not lines:
        return {}
    out, i = block(0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unsupported YAML near line: {lines[i][1]!r}")
    return out


def load_yaml(path: str) -> dict:
    with open(path) as f:
        return parse_yaml(f.read())


def model_config_from_yaml(raw: dict) -> ModelConfig:
    """Build a ModelConfig from a reference-style YAML dict."""
    eg = raw.get("egnn_params", {})
    di = raw.get("diffusion_params", {})
    egnn = EGNNConfig(
        joint_nf=eg.get("joint_nf", 128),
        hidden_nf=eg.get("hidden_nf", 256),
        n_layers=eg.get("n_layers", 6),
        inv_sublayers=eg.get("inv_sublayers", 1),
        attention=eg.get("attention", True),
        tanh=eg.get("tanh", True),
        norm_constant=eg.get("norm_constant", 1.0),
        sin_embedding=eg.get("sin_embedding", False),
        normalization_factor=eg.get("normalization_factor", 100.0),
        aggregation_method=eg.get("aggregation_method", "sum"),
        reflection_equivariant=eg.get("reflection_equivariant", False),
        edge_cutoff_ligand=eg.get("edge_cutoff_ligand"),
        edge_cutoff_pocket=eg.get("edge_cutoff_pocket"),
        edge_cutoff_interaction=eg.get("edge_cutoff_interaction"),
        edge_embedding_dim=eg.get("edge_embedding_dim"),
        update_pocket_coords=raw.get("mode", "pocket_conditioning") == "joint",
    )
    diffusion = DiffusionConfig(
        timesteps=di.get("diffusion_steps", 500),
        noise_schedule=di.get("diffusion_noise_schedule", "polynomial_2"),
        noise_precision=di.get("diffusion_noise_precision", 5e-4),
        norm_values=tuple(di.get("normalize_factors", (1.0, 4.0))),
    )
    dataset = raw.get("dataset", "crossdock")
    if raw.get("pocket_representation", "full-atom") == "full-atom" and \
            dataset == "crossdock":
        dataset = "crossdock_full"
    from diffndm_tpu_torch.constants import dataset_params

    if dataset not in dataset_params:
        raise ValueError(f"dataset {dataset!r} is not supported by the port "
                         f"(supported: {sorted(dataset_params)})")
    params = dataset_params[dataset]
    # the reference drops the trailing 'others' one-hot column to match the
    # 10-type checkpoint; size the feature dims to the non-pad type count
    nf = len(params["atom_decoder"]) - params["_pad_types"]
    return ModelConfig(
        dataset=dataset,
        mode=raw.get("mode", "pocket_conditioning"),
        pocket_representation=raw.get("pocket_representation", "full-atom"),
        atom_nf=nf,
        residue_nf=(nf if raw.get("pocket_representation") == "full-atom"
                    else len(params["aa_decoder"])),
        egnn=egnn,
        diffusion=diffusion,
    )
