"""Filename label grammars.

The reference encodes image-level labels *in filenames* under two grammars
(SURVEY.md §0):

* WSSS4LUAD ``bracket-list``: ``name-[1, 0, 1].png`` — parsed by
  ``utils.py:26-51`` (``get_label`` + ``to_list``).
* BCSS ``digit-string``: ``name[1101].png`` — parsed by
  ``utils.py:20-21`` (``get_file_label``).

The port's own copy of the parsers in ``pistoseg_tpu/data/labels.py``.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import List, Union

PathLike = Union[str, Path]


def parse_label_str(stem_or_path: PathLike, grammar: str) -> str:
    """Extract the raw label substring (without brackets) from a filename."""
    name = Path(str(stem_or_path)).name
    m = re.search(r"\[([^\]]*)\]", name)
    if not m:
        raise ValueError(f"no [label] found in filename: {name}")
    return m.group(1)


def parse_label(stem_or_path: PathLike, grammar: str) -> List[int]:
    """Parse the image-level multilabel vector from a filename."""
    raw = parse_label_str(stem_or_path, grammar)
    if grammar == "bracket-list":
        return [int(tok) for tok in raw.split(",")]
    if grammar == "digit-string":
        return [int(ch) for ch in raw.strip()]
    raise ValueError(f"unknown label grammar: {grammar}")
