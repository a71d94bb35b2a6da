"""Webdataset-style tar shard reading (the port's own copy of
clipcap_tpu/data/webdataset.py; stdlib tarfile, no webdataset dependency).

The upstream preprocessing CLI the reference documents (README.md:5-22)
consumes `--input_dataset "./webdataset/{000..123}.tar"` with
`--wds_image_key jpg --wds_caption_key txt`. This module provides:

- brace_expand: the {000..123} shard-range syntax;
- iter_samples: group tar members by key (basename before the first dot),
  yielding {"__key__": key, ext: bytes} dicts in shard order.
"""

from __future__ import annotations

import re
import tarfile
from pathlib import Path
from typing import Dict, Iterator, List, Sequence, Union

_BRACE = re.compile(r"\{(\d+)\.\.(\d+)\}")


def brace_expand(pattern: str) -> List[str]:
    """Expand one {AAA..BBB} numeric range (zero-padded like the bounds)."""
    m = _BRACE.search(pattern)
    if not m:
        return [pattern]
    lo, hi = m.group(1), m.group(2)
    width = len(lo)
    return [pattern[: m.start()] + str(i).zfill(width) + pattern[m.end():]
            for i in range(int(lo), int(hi) + 1)]


def iter_samples(
    shards: Union[str, Sequence[str]],
    keys: Sequence[str] = ("jpg", "txt"),
) -> Iterator[Dict[str, bytes]]:
    """Stream key-grouped samples from tar shards.

    Members are grouped by the basename up to the first dot (webdataset
    convention); a sample is emitted once all requested keys are present
    when the group ends. Samples missing a requested key are skipped.
    """
    if isinstance(shards, str):
        shards = brace_expand(shards)
    for shard in shards:
        with tarfile.open(shard, "r|*") as tf:  # streaming mode
            current_key = None
            current: Dict[str, bytes] = {}
            for member in tf:
                if not member.isfile():
                    continue
                name = Path(member.name).name
                if "." not in name:
                    continue
                key, ext = name.split(".", 1)
                if current_key is not None and key != current_key:
                    if all(k in current for k in keys):
                        yield {"__key__": current_key, **current}
                    current = {}
                current_key = key
                if ext in keys:
                    current[ext] = tf.extractfile(member).read()
            if current_key is not None and all(k in current for k in keys):
                yield {"__key__": current_key, **current}
