"""YAML configs with hyperpyyaml-style ``!ref`` interpolation: the port's
copy of `fseend_tpu/utils/config.py` (yaml only).

The reference drives everything from hyperpyyaml files with the sections
``log / training / model / data / task / debug`` and references such as
``max_seqlen: !ref <data[chunk_size]>``.  This module reads that surface
without hyperpyyaml: plain yaml and a resolver for ``!ref <a[b][c]>``
strings, including simple arithmetic (``!ref <a[b]> * 2``); the other
hyperpyyaml tags are kept as strings.
"""

from __future__ import annotations

import copy
import re
from pathlib import Path
from typing import Any

import yaml

_REF_RE = re.compile(r"<([A-Za-z0-9_]+(?:\[[A-Za-z0-9_]+\])*)>")


def _ref_constructor(loader, node):
    return "!ref " + loader.construct_scalar(node)


class _ConfigLoader(yaml.SafeLoader):
    pass


_ConfigLoader.add_constructor("!ref", _ref_constructor)
for _tag in ("!new:", "!name:", "!apply:"):
    _ConfigLoader.add_multi_constructor(
        _tag, lambda loader, suffix, node, _t=_tag: f"{_t}{suffix}")


def _lookup(root: dict, path: str) -> Any:
    head, *rest = re.split(r"[\[\]]+", path.strip("[]"))
    cur = root[head]
    for key in rest:
        if key == "":
            continue
        cur = cur[int(key)] if isinstance(cur, list) else cur[key]
    return cur


def _resolve_value(value: Any, root: dict) -> Any:
    if isinstance(value, str) and value.startswith("!ref "):
        expr = value[len("!ref "):].strip()
        matches = list(_REF_RE.finditer(expr))
        if not matches:
            return expr
        # a single reference: the referenced object, of any type
        if len(matches) == 1 and matches[0].group(0) == expr:
            return _resolve_value(_lookup(root, matches[0].group(1)), root)

        # arithmetic over references, e.g. "<a[b]> * 2"
        def sub(m):
            return repr(_resolve_value(_lookup(root, m.group(1)), root))

        return eval(_REF_RE.sub(sub, expr), {"__builtins__": {}}, {})  # noqa: S307
    if isinstance(value, dict):
        return {k: _resolve_value(v, root) for k, v in value.items()}
    if isinstance(value, list):
        return [_resolve_value(v, root) for v in value]
    return value


def resolve_refs(cfg: dict) -> dict:
    """Every !ref resolved against the document's root (to a fixpoint)."""
    cfg = copy.deepcopy(cfg)
    for _ in range(10):
        new = _resolve_value(cfg, cfg)
        if new == cfg:
            return new
        cfg = new
    return cfg


def load_config(path: str | Path, overrides: dict | None = None) -> dict:
    """A yaml config file with its !ref interpolation resolved and the
    overrides applied, given as dotted paths: ``{"training.batch_size": 4}``."""
    with open(path) as f:
        cfg = yaml.load(f, Loader=_ConfigLoader)
    for dotted, val in (overrides or {}).items():
        cur = cfg
        *parents, leaf = dotted.split(".")
        for p in parents:
            cur = cur.setdefault(p, {})
        cur[leaf] = val
    return resolve_refs(cfg)


def dump_config(cfg: dict, path: str | Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
