"""Experiment configuration.

Port of ``audio2face_tpu/config.py``: the same ``config.yaml`` keys and
defaults, including the historical ``percision`` spelling, which stays the
canonical YAML key; a ``precision`` alias is accepted too. A plain frozen
dataclass that checks and coerces its field types itself.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional


def _coerce(name: str, value, kind: str):
    """``value`` as ``kind`` ("int", "float", "bool", "str", "pair"; a
    leading "?" allows None), with YAML's habits allowed for: ``1e-4`` loads
    as a string, a pair as a list."""
    if kind.startswith("?"):
        if value is None:
            return None
        kind = kind[1:]
    ok = False
    if kind == "bool":
        ok = isinstance(value, bool)
    elif kind == "str":
        ok = isinstance(value, str)
    elif kind == "int":
        if isinstance(value, float) and value.is_integer():
            value = int(value)
        ok = isinstance(value, int) and not isinstance(value, bool)
    elif kind == "float":
        if isinstance(value, str):
            try:
                value = float(value)
            except ValueError:
                pass
        ok = isinstance(value, (int, float)) and not isinstance(value, bool)
        value = float(value) if ok else value
    elif kind == "pair":
        if isinstance(value, (list, tuple)) and len(value) == 2:
            value = tuple(_coerce(name, v, "int") for v in value)
            ok = True
    if not ok:
        raise TypeError(f"ExpConfig.{name}: expected {kind}, got {value!r}")
    return value


# YAML 1.1's implicit scalar types as PyYAML's SafeLoader resolves them, for
# the forms a flat config file uses (so ``1e-4``, with no dot, stays a string)
_YAML_NULL = re.compile(r"~|null|Null|NULL|")
_YAML_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_YAML_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")})
_YAML_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_YAML_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|[-+]?\.[0-9_]+(?:[eE][-+][0-9]+)?")
# forms PyYAML reads as something this reader does not resolve (octal, hex,
# sexagesimal, special floats, timestamps, anchors, tags, block values)
_YAML_OTHER = re.compile(r"[-+]?0[0-9xob_]|[-+]?[0-9][0-9_]*:|[-+]?\.(?:inf|Inf|INF|nan|NaN|NAN)$"
                         r"|[0-9]{4}-[0-9]{2}-[0-9]{2}|[&*!|>{@`%]|[-?:](?:\s|$)")


def _yaml_scalar(text: str):
    if text[:1] in ("'", '"'):
        quote = text[0]
        if len(text) < 2 or text[-1] != quote or (quote == '"' and "\\" in text):
            raise ValueError(f"unsupported quoted value {text!r}")
        body = text[1:-1]
        return body.replace("''", "'") if quote == "'" else body
    if _YAML_NULL.fullmatch(text):
        return None
    if text in _YAML_BOOL:
        return _YAML_BOOL[text]
    if _YAML_INT.fullmatch(text):
        return int(text.replace("_", ""))
    if _YAML_FLOAT.fullmatch(text):
        return float(text.replace("_", ""))
    if _YAML_OTHER.match(text):
        raise ValueError(f"unsupported value {text!r}")
    return text


def read_flat_yaml(text: str) -> dict:
    """A flat ``key: value`` YAML document (the form of ``config.yaml`` and
    ``configs/*.yaml``: scalars, quoted strings, ``[a, b]`` lists of
    scalars, ``#`` comments) as ``yaml.safe_load`` reads it. Raises
    ValueError on anything else: nesting, multi-line values, anchors, tags,
    or scalar forms it does not resolve."""
    out: dict = {}
    for n, raw in enumerate(text.splitlines(), start=1):
        line = raw
        # a comment starts at a '#' outside quotes that follows whitespace
        quote = None
        for i, ch in enumerate(line):
            if quote:
                quote = None if ch == quote else quote
            elif ch in ("'", '"'):
                quote = ch
            elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
                line = line[:i]
                break
        if not line.strip() or line.strip() == "---":
            continue
        if line[0] in " \t" or ":" not in line:
            raise ValueError(f"line {n}: not a flat 'key: value' line: {raw!r}")
        key, _, value = line.partition(":")
        key, value = key.strip(), value.strip()
        if value.startswith("[") and value.endswith("]"):
            inner = value[1:-1].strip()
            out[key] = [_yaml_scalar(v.strip()) for v in inner.split(",")] if inner else []
        else:
            try:
                out[key] = _yaml_scalar(value)
            except ValueError as e:
                raise ValueError(f"line {n}: {e}") from None
    return out


@dataclasses.dataclass(frozen=True)
class ExpConfig:
    """Full experiment schema, loadable from a YAML file.

    - dataset: ``batch_size``
    - model: ``modelname``, ``one_hot_size``, ``feature_extractor``,
      ``sample_rate``, ``vertex_count``, ``split_frame``, ``n_feature``,
      ``out_dim``, ``win_length``, ``hop_length``; FaceFormer's decoder
      width ``feature_dim`` (an extension, 64 unless given)
    - training: ``percision`` (sic), ``lr``
    - loss: ``loss``
    """

    # dataset
    batch_size: int
    # model
    modelname: str
    one_hot_size: int
    feature_extractor: Optional[str]
    sample_rate: int
    vertex_count: int
    split_frame: bool
    n_feature: int
    out_dim: int
    win_length: int
    hop_length: Optional[int] = None
    # training
    percision: str = "16-mixed"
    lr: float = 1e-4
    # loss
    loss: Optional[str] = None
    # ---- extensions (absent keys default to reference behavior) ----
    # random seed for params/dropout
    seed: int = 0
    # maximum decoded sequence length (frames) for faceformer-style models
    max_seq_len: int = 3600
    # device mesh axes (data, model); -1 = all remaining devices. Kept as a
    # key; the trainer takes one device until the parallel modules are ported
    mesh_shape: tuple = (-1, 1)
    # training schedule
    max_epochs: int = 50
    early_stop_patience: int = 5
    # gradient accumulation: split each batch into k microbatches, average
    # their grads, apply ONE optimizer update (batch_size must divide by k)
    accumulate_grad_batches: int = 1
    # shard params + optimizer moments over the data axis; kept as a key
    fsdp: bool = False
    # dataset family: "vocaset" or "biwi"
    dataset: str = "vocaset"
    # FaceFormer's decoder width (the upstream BIWI model: 128)
    feature_dim: int = 64
    # accepted in place of ``percision``
    precision: dataclasses.InitVar[Optional[str]] = None

    _KINDS = {
        "batch_size": "int", "modelname": "str", "one_hot_size": "int",
        "feature_extractor": "?str", "sample_rate": "int", "vertex_count": "int",
        "split_frame": "bool", "n_feature": "int", "out_dim": "int", "win_length": "int",
        "hop_length": "?int", "percision": "str", "lr": "float", "loss": "?str",
        "seed": "int", "max_seq_len": "int", "mesh_shape": "pair", "max_epochs": "int",
        "early_stop_patience": "int", "accumulate_grad_batches": "int", "fsdp": "bool",
        "dataset": "str", "feature_dim": "int",
    }

    def __post_init__(self, precision):
        if precision is not None and self.percision == "16-mixed":
            object.__setattr__(self, "percision", precision)
        for name, kind in self._KINDS.items():
            object.__setattr__(self, name, _coerce(name, getattr(self, name), kind))

    @classmethod
    def from_dict(cls, config: dict) -> "ExpConfig":
        """From a mapping of YAML keys; keys the schema does not know are
        ignored."""
        known = set(cls._KINDS) | {"precision"}
        return cls(**{k: v for k, v in config.items() if k in known})

    @classmethod
    def from_yaml(cls, path: str) -> "ExpConfig":
        """From a YAML file: through PyYAML where it is installed, else
        through ``read_flat_yaml``, which reads the repo's flat config files
        the same way."""
        with open(path, "r") as f:
            text = f.read()
        try:
            import yaml
        except ImportError:
            return cls.from_dict(read_flat_yaml(text))
        return cls.from_dict(yaml.safe_load(text))

    def model_copy(self, update: Optional[dict] = None) -> "ExpConfig":
        """A copy with ``update`` applied (and checked)."""
        return dataclasses.replace(self, **(update or {}))

    def name(self) -> str:
        """Run/version name, identical in format to the reference."""
        return f"{self.modelname}_{self.feature_extractor}_{self.lr}_{self.loss}_{self.percision}"

    @property
    def n_verts(self) -> int:
        return self.vertex_count

    @property
    def bf16_compute(self) -> bool:
        """True when the reference-style AMP string requests reduced
        precision ("16-mixed", "bf16-mixed"): bfloat16 compute with float32
        parameters and optimizer state."""
        p = self.percision.lower()
        return "16" in p or "bf16" in p

    def apply_faceformer_overrides(self) -> "ExpConfig":
        """The reference special-cases faceformer: whole-sentence items,
        batch size 1, no standalone feature extractor."""
        if self.modelname == "faceformer":
            return self.model_copy(
                update={"split_frame": False, "batch_size": 1, "feature_extractor": None}
            )
        return self
