"""Where in ``ROADMAP.md`` (§1, the queue) each part of the reference that
the port lacks is ported: one map, read by every ``NotImplementedError``
the port raises for a missing part."""

from __future__ import annotations

__all__ = ["not_ported"]

_ROADMAP_ITEM = {
    "multi-rank device scheduler": "queue item 8, a multi-rank device scheduler",
}


def not_ported(what: str) -> NotImplementedError:
    """The error for a part of the reference the port does not have yet."""
    return NotImplementedError(
        f"{what!r} is not ported yet: ROADMAP.md §1, {_ROADMAP_ITEM[what]}"
    )
