"""Accelerator constants and card identification for the planner.

The port of ``defer_tpu.utils.hw``.  Peaks are bf16 dense FLOP/s per
device; the interconnect figure is one-way bytes/s per link (the
stage-to-stage hop rides one link).

The CUDA card's row comes from its data sheet: the H100 SXM (``"h100"``,
named "NVIDIA H100 80GB HBM3" by ``torch.cuda.get_device_name``) has
989e12 bf16 dense FLOP/s, 3.35e12 HBM bytes/s and 450e9 one-way NVLink
bytes/s.  A card
this table does not place (the H100 PCIe or NVL, any other card) is
``"unknown"``, and so is the CPU: callers never borrow another card's
peaks.

The TPU rows below are the JAX package's, kept as data for one purpose:
``plan.StageCostModel`` ranks nodes against the ``v5e`` row when the
generation is unknown, and a plan made with ``gen="v5e"`` gives the same
cuts in both packages.  They are not this port's hardware.
"""

from __future__ import annotations

PEAK_BF16_FLOPS: dict[str, float] = {
    "h100": 989e12,
    "v2": 46e12,
    "v3": 123e12,
    "v4": 275e12,
    "v5e": 197e12,
    "v5p": 459e12,
    "v6e": 918e12,
}

#: one-way interconnect bandwidth per link, bytes/s (NVLink for the card,
#: ICI for the TPU rows)
ICI_BW_BYTES_S: dict[str, float] = {
    "h100": 4.5e11,
    "v2": 5.0e10,
    "v3": 7.0e10,
    "v4": 4.5e10,
    "v5e": 4.5e10,
    "v5p": 9.0e10,
    "v6e": 9.0e10,
}

#: HBM bandwidth, bytes/s (data-sheet numbers)
HBM_BW_BYTES_S: dict[str, float] = {
    "h100": 3.35e12,
    "v2": 7.0e11,
    "v3": 9.0e11,
    "v4": 1.228e12,
    "v5e": 8.19e11,
    "v5p": 2.765e12,
    "v6e": 1.64e12,
}


def hbm_bandwidth(gen: str) -> float:
    """HBM bytes/s for a generation; 0.0 when unknown."""
    return HBM_BW_BYTES_S.get(gen, 0.0)


def card_generation(name: str) -> str:
    """The row name for a CUDA card's name, or ``"unknown"``.

    Only the H100 SXM has a row: its name carries ``H100`` and ``HBM3``;
    the PCIe and NVL variants (other clocks, memory rates and links) name
    themselves and stay unknown."""
    n = name.lower()
    if "h100" in n and "hbm3" in n and "pcie" not in n and "nvl" not in n:
        return "h100"
    return "unknown"


def identify_chip(device) -> str:
    """Generation string for a ``torch.device`` (or a CUDA card index), or
    ``"unknown"``.

    A CPU device is ``"unknown"``; a CUDA device is looked up by
    ``torch.cuda.get_device_name`` (which raises where CUDA is missing:
    asking about a card that is not there is the caller's error)."""
    import torch

    if isinstance(device, int):
        device = torch.device("cuda", device)
    device = torch.device(device)
    if device.type != "cuda":
        return "unknown"
    return card_generation(torch.cuda.get_device_name(device))


def peak_flops(gen: str) -> float:
    """bf16 peak FLOP/s for a generation; 0.0 when unknown (callers must
    not fabricate MFU against a guessed peak)."""
    return PEAK_BF16_FLOPS.get(gen, 0.0)


def ici_bandwidth(gen: str) -> float:
    """One-way interconnect bytes/s per link; 0.0 when unknown."""
    return ICI_BW_BYTES_S.get(gen, 0.0)


def analytic_pipeline_model(stage_latencies_s: list[float],
                            bytes_per_hop: int,
                            ici_bw_bytes_s: float) -> dict:
    """Predicted N-device pipeline speedup from measured single-device
    inputs.

    * a single device runs the stages back to back: ``T1 = sum(lat)``;
    * the full pipeline's steady-state step time is its slowest stage,
      plus the hop where it cannot overlap: ``Tstep = max(lat) + hop``
      (hop fully serialized — conservative);
    * predicted speedup = ``T1 / Tstep``; the balance ratio ``max/mean``
      says how much of the ideal N is lost to partition skew.
    """
    lats = list(stage_latencies_s)
    n = len(lats)
    t1 = sum(lats)
    tmax = max(lats)
    hop_s = (bytes_per_hop / ici_bw_bytes_s) if ici_bw_bytes_s > 0 else 0.0
    tstep = tmax + hop_s
    return {
        "num_stages": n,
        "sum_stage_ms": round(t1 * 1e3, 4),
        "max_stage_ms": round(tmax * 1e3, 4),
        "hop_ms": round(hop_s * 1e3, 5),
        "balance_max_over_mean": round(tmax / (t1 / n), 4) if t1 else None,
        "predicted_speedup_vs_single_chip": round(t1 / tstep, 4)
        if tstep else None,
        "predicted_efficiency_vs_ideal": round(t1 / tstep / n, 4)
        if tstep else None,
        "comm_model": "hop serialized after slowest stage (conservative)",
    }
