"""Waiver parsing for the port's contract checker.

A waiver suppresses one (or more) rules on one line of code:

    dist.barrier()  # spjoin-lint-torch: allow[collective-site] -- why this is sound here

or, as a standalone comment, it applies to the next code line:

    # spjoin-lint-torch: allow[collective-site] -- why this is sound here
    dist.barrier()

The `-- justification` part is mandatory (the waiver-hygiene rule), as is
naming a real rule and suppressing something; the total waiver count
across the tree is capped by ``config.MAX_WAIVERS``.
"""
from __future__ import annotations

import dataclasses
import re

WAIVER_RE = re.compile(
    r"#\s*spjoin-lint-torch:\s*allow\[([A-Za-z0-9_,\- ]+)\]\s*(?:--\s*(.*\S))?\s*$"
)


@dataclasses.dataclass
class Waiver:
    file: str
    line: int  # line the waiver comment sits on
    target_line: int  # line of code the waiver applies to
    rules: tuple[str, ...]
    justification: str
    used: bool = False


def parse_waivers(source: str, filename: str) -> list[Waiver]:
    """Extract every waiver in ``source``; standalone comment lines bind to
    the next non-blank, non-comment line."""
    lines = source.splitlines()
    out: list[Waiver] = []
    for i, text in enumerate(lines, start=1):
        m = WAIVER_RE.search(text)
        if not m:
            continue
        rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        target = i
        if text.lstrip().startswith("#"):  # standalone comment: next code line
            for j in range(i, len(lines)):
                nxt = lines[j].strip()
                if nxt and not nxt.startswith("#"):
                    target = j + 1
                    break
        out.append(Waiver(file=filename, line=i, target_line=target, rules=rules,
                          justification=(m.group(2) or "").strip()))
    return out


def waivers_by_target(waivers: list[Waiver]) -> dict[int, list[Waiver]]:
    by_line: dict[int, list[Waiver]] = {}
    for w in waivers:
        by_line.setdefault(w.target_line, []).append(w)
    return by_line
