"""Sharding: the reference's logical-axis rules as DTensor placements."""

from .sharding import *  # noqa: F401,F403
