"""YAML-backed CLI config parser (a copy of rohm_tpu/utils/config.py).

The reference uses configargparse with YAMLConfigFileParser: every flag is
declared per-script, `--config file.yaml` supplies defaults whose keys mirror
flag names, and CLI flags override YAML (reference train_trajnet.py:16-79).
configargparse isn't available here, so this is a small argparse wrapper with
identical semantics, including the reference's bool convention
(`lambda x: x.lower() in ['true','1']`).
"""

from __future__ import annotations

import argparse
from typing import Any

import yaml


def str2bool(x) -> bool:
    """Reference bool parsing: 'true'/'1' (case-insensitive) are True."""
    if isinstance(x, bool):
        return x
    return str(x).lower() in ["true", "1"]


def fused_mode(x):
    """--fused_posenet parser: bool-style values select the default fused
    kernel (bf16) or the plain module; the strings 'bf16'/'int8'/'f32' pick a kernel."""
    if isinstance(x, bool):
        return x
    s = str(x).lower()
    if s in ("bf16", "int8", "int8qa", "f32"):
        return s
    return str2bool(s)


def strip_flag(argv: list[str], flag: str) -> list[str]:
    """Remove `--flag`, `--flag=value`, and `--flag value` occurrences from an
    argv list (used by --via_server to forward everything else verbatim)."""
    out: list[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == flag or a.startswith(flag + "="):
            if a == flag and i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                i += 1  # space-separated value
            i += 1
            continue
        out.append(a)
        i += 1
    return out


class ConfigParser:
    """argparse + YAML defaults. Precedence: CLI flag > YAML value > default."""

    def __init__(self, description: str = ""):
        self._parser = argparse.ArgumentParser(description=description)
        self._parser.add_argument("--config", type=str, default="", help="YAML config file")
        self._types: dict[str, Any] = {}
        self._aliases: dict[str, str] = {}

    def add_argument(
        self, name: str, *aliases: str, type=str, default=None, help: str = "", nargs=None
    ):
        """Declare a flag. Extra positional names are aliases: the first name
        defines the attribute, the rest are accepted on the CLI and in YAML."""
        if type is bool or type == str2bool:
            type = str2bool
        dest = name.lstrip("-").replace("-", "_")
        kwargs = dict(type=type, default=None, help=help, dest=dest)
        if nargs is not None:
            kwargs["nargs"] = nargs
        self._parser.add_argument(name, *aliases, **kwargs)
        self._types[dest] = (type, default, nargs)
        for alias in aliases:
            self._aliases[alias.lstrip("-").replace("-", "_")] = dest
        return self

    # reference scripts call parser.parse_args() and read attrs
    def parse_args(self, argv=None) -> argparse.Namespace:
        cli = self._parser.parse_args(argv)
        yaml_vals = {}
        if cli.config:
            with open(cli.config) as f:
                yaml_vals = yaml.safe_load(f) or {}

        # YAML may use alias keys; fold them onto the canonical name
        for alias, dest in self._aliases.items():
            if alias in yaml_vals and dest not in yaml_vals:
                yaml_vals[dest] = yaml_vals.pop(alias)

        out = argparse.Namespace(config=cli.config)
        for key, (typ, default, nargs) in self._types.items():
            cli_val = getattr(cli, key, None)
            if cli_val is not None:
                val = cli_val
            elif key in yaml_vals:
                val = yaml_vals[key]
                if val is not None and nargs is None:
                    val = typ(val)
            else:
                val = default
            setattr(out, key, val)
        # pass through unknown YAML keys so configs stay forward-compatible
        for key, val in yaml_vals.items():
            if not hasattr(out, key):
                setattr(out, key, val)
        return out
