"""Replica fleet wire frames (the port of ``sutro_tpu/fleet/``, frames
only: the router, membership, health, affinity, the observability plane
and replay are not ported yet, ROADMAP.md §1 "Serving and fleet").

The server (``server.py``) answers ``/fleet-state``, ``/fleet-warm``,
``/metrics-snapshot`` and ``/trace-doc`` with :mod:`.frames`.
"""

from . import frames

__all__ = ["frames"]
