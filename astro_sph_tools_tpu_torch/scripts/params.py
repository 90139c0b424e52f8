"""Declarative CLI parameter specs (ScriptWrapper equivalent).

Counterpart: ``astro_sph_tools_tpu/scripts/params.py``, copied (it uses
``argparse`` only).

The reference declares CLI surfaces with ``QuasarCode``'s
``ScriptWrapper.ParamSpec`` — typed positional/optional params, flags,
conversion functions, and mutually-exclusive conflicts
(the reference's ``_scripts/find_nearest_haloes.py:24-89``).
This module provides the same declarative shape over ``argparse``.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence


@dataclass
class Param:
    """One CLI parameter."""

    name: str
    short_name: Optional[str] = None
    description: str = ""
    param_type: type = str
    required: bool = False
    default: Any = None
    is_flag: bool = False
    conversion: Optional[Callable[[str], Any]] = None
    conflicts: tuple[str, ...] = ()
    sets_param: Optional[str] = None  # flag stores True into this name


def comma_separated(item_type: type = str) -> Callable[[str], list]:
    def convert(text: str) -> list:
        if not text:
            return []
        return [item_type(v.strip()) for v in text.split(",")]

    return convert


@dataclass
class ScriptWrapper:
    """Declarative script runner: name, description, params, main function."""

    command: str
    description: str = ""
    parameters: Sequence[Param] = field(default_factory=tuple)

    def build_parser(self) -> argparse.ArgumentParser:
        parser = argparse.ArgumentParser(prog=self.command, description=self.description)
        for p in self.parameters:
            names = [f"--{p.name.replace('_', '-')}"]
            if p.short_name:
                names.append(f"-{p.short_name}")
            # argparse %-expands help text; literal '%' (e.g. "5% of the
            # region side") must be escaped or --help raises TypeError
            kwargs: dict = {
                "help": p.description.replace("%", "%%"),
                "dest": p.name,
            }
            if p.is_flag:
                kwargs["action"] = "store_true"
            else:
                kwargs["type"] = p.conversion or p.param_type
                kwargs["default"] = p.default
                kwargs["required"] = p.required
            parser.add_argument(*names, **kwargs)
        return parser

    def parse(self, argv: Optional[Sequence[str]] = None) -> dict:
        args = vars(self.build_parser().parse_args(argv))
        # conflict validation
        for p in self.parameters:
            if not args.get(p.name):
                continue
            for other in p.conflicts:
                if args.get(other):
                    raise SystemExit(
                        f"error: --{p.name.replace('_', '-')} conflicts with "
                        f"--{other.replace('_', '-')}"
                    )
        return args

    def run(self, main: Callable[..., Any], argv: Optional[Sequence[str]] = None):
        return main(**self.parse(argv))
