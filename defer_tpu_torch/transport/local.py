"""Transport-tier negotiation, receiver side: the port's answer to a probe.

A sender that hopes for a colocated fast path (``local``, ``shm`` or
``ici`` in the JAX package's ``transport/local.py``, ``shm.py`` and
``ici.py``) dials TCP as always and then offers the path with a
``{"cmd": "tier_probe", ...}`` control frame, parking until a
``tier_reply`` comes back.  The port has only the tcp rung so far (the
colocated tiers are ROADMAP item A10d), so its stage nodes and dispatcher
refuse every offer — but they always answer, so a JAX peer that probes a
port node degrades to tcp instead of waiting forever.
"""

from __future__ import annotations

from .framed import send_ctrl


def answer_probe(conn, msg, *, accept: bool = False) -> None:
    """Answer a ``tier_probe`` on ``conn`` with ``{"cmd": "tier_reply",
    "tier": "tcp"}``: the hop stays on the wire.  ``accept=True`` asks for
    a colocated tier the port does not have, and raises."""
    del msg
    if accept:
        raise NotImplementedError(
            "colocated transport tiers (local, shm, ici) come with ROADMAP "
            "item A10d; the port's hops run over tcp")
    send_ctrl(conn, {"cmd": "tier_reply", "tier": "tcp"})
