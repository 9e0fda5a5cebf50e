"""Timeout-safe benchmark-artifact writing: the port of
``defer_tpu.utils.artifact``.

A measurement sweep that runs under a wall-clock limit must keep every
row it completed.  ``flush_artifact`` gives the two properties that needs:

- **atomic**: write to ``path + ".part"`` then ``os.replace``, so a kill
  mid-write can never truncate the artifact;
- **merging**: rows already present on disk (e.g. from a timed-out first
  run, re-run with a row filter) are preserved unless the new payload
  re-measured them, and the headline ``value`` is recomputed over the
  MERGED rows — a partial re-run can only add information, never lose
  the rows the incremental flush exists to keep.

The file is the JAX package's, byte for byte, for the same payload.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any


def flush_artifact(path: str | None, payload: dict[str, Any],
                   merge_key: str | None = None,
                   value_key: str = "tokens_per_s",
                   row_filter=None,
                   merge_prior: bool = False) -> dict[str, Any]:
    """Atomically write ``payload`` as one JSON line to ``path``.

    When ``merge_key`` names a dict of rows inside the payload, the
    headline ``"value"`` (when present in the payload) is recomputed as
    the max ``value_key`` over those rows — restricted to row names
    accepted by ``row_filter`` when given — so stdout and artifact can
    never disagree.

    ``merge_prior=True`` additionally keeps rows already on disk at
    ``path`` that this run did not re-measure.  Pass it ONLY for a
    filtered partial re-run: merging unconditionally would let rows from
    an obsolete sweep configuration survive a full re-run and own the
    headline.  A missing, empty, or malformed prior artifact is ignored.

    When ``path`` is falsy nothing is written (value recomputation
    still happens); a failed write is reported on stderr but never
    raises — an unwritable artifact path must not kill the sweep the
    incremental flush exists to protect.  Returns the payload as
    written/printed.
    """
    if merge_key is not None:
        if path and merge_prior:
            try:
                with open(path) as f:
                    text = f.read().strip()
                prev = json.loads(text.splitlines()[-1]) if text else {}
                if not isinstance(prev, dict):
                    prev = {}
            except (OSError, ValueError):
                prev = {}
            merged = dict(prev.get(merge_key) or {}) \
                if isinstance(prev.get(merge_key), dict) else {}
            merged.update(payload.get(merge_key) or {})
            payload = {**payload, merge_key: merged}
        rows = payload.get(merge_key) or {}
        if "value" in payload:
            ok = [v[value_key] for k, v in rows.items()
                  if isinstance(v, dict) and value_key in v
                  and (row_filter is None or row_filter(k))]
            if ok:
                payload["value"] = max(ok)
    if not path:
        return payload
    try:
        tmp = path + ".part"
        with open(tmp, "w") as f:
            f.write(json.dumps(payload) + "\n")
        os.replace(tmp, path)
    except OSError as e:
        print(f"flush_artifact: could not write {path}: {e!r}",
              file=sys.stderr, flush=True)
    return payload
