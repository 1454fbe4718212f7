"""Three-term roofline of the card the port runs on (the reference's
`launch/roofline.py`, priced for an NVIDIA H100 instead of a TPU).

  compute term    = FLOPs_per_device / peak_FLOP/s
  memory term     = bytes_per_device / HBM_bw
  collective term = collective_bytes_per_device / link_bw

The reference also parses collective bytes out of XLA's compiled HLO text
(`collective_bytes`). The port compiles no HLO, so that function has no
counterpart: its collective bytes are the tensors the distributed
backend's stage-1 gather moves onto the first slot's device,
`core.distributed.DistributedSearch.gather_bytes` (what
`launch/ann_dryrun.py` reports under `collectives`).
"""

from __future__ import annotations

import dataclasses

__all__ = ["HW", "roofline_terms", "model_flops"]


@dataclasses.dataclass(frozen=True)
class HW:
    """NVIDIA H100 80GB HBM3 (SXM) at its full 700 W power limit: NVIDIA's
    data-sheet peaks, dense rates without sparsity. A card set below 700 W
    (`nvidia-smi --query-gpu=power.limit`) runs slower under load, so a
    share of these peaks is stated beside the card's limit.

    The reference's `HW` held TPU v5e figures (197 TFLOP/s bf16, 819 GB/s,
    a 50 GB/s ICI link, 16 GB); none of them carries over. `link_bw` takes
    the place of its `ici_bw`."""

    peak_flops: float = 989e12      # bf16 / fp16 FLOP/s on the tensor cores
    hbm_bw: float = 3.35e12         # B/s
    link_bw: float = 450e9          # B/s, NVLink 4 in one direction
    hbm_bytes: float = 80e9
    # the unit peaks the kernel bounds of chip_smoke.py are priced with
    tf32_flops: float = 495e12      # TF32 tensor cores
    fp32_flops: float = 67e12       # float32 outside the tensor cores
    int8_ops: float = 1979e12       # int8 tensor cores
    # shared-memory lookups a second: 32 banks a clock on each of 132 SMs
    # at the 1.98 GHz boost clock (Hopper white paper)
    smem_lookups: float = 32 * 132 * 1.98e9
    # Storage tier: the paper's SmartSSD figure (§6.5 measures ~3 GB/s of
    # flash-to-accelerator P2P-DMA and shows the platform bound by it at
    # SIFT1B scale). It is neither a card figure nor this machine's disk:
    # `obs.calibrate` fits the bandwidth a csd store really delivers.
    ssd_bw: float = 3.0e9           # B/s per device


def roofline_terms(flops_per_dev, bytes_per_dev, coll_bytes_per_dev,
                   hw: HW = HW()):
    t_c = flops_per_dev / hw.peak_flops
    t_m = bytes_per_dev / hw.hbm_bw
    t_n = coll_bytes_per_dev / hw.link_bw
    terms = {"compute_s": t_c, "memory_s": t_m, "collective_s": t_n}
    dom = max(terms, key=terms.get)
    bound = max(t_c, t_m, t_n)
    frac = t_c / bound if bound > 0 else 0.0
    return {**terms, "dominant": dom, "compute_fraction": frac}


def model_flops(n_params_active: float, tokens: float, kind: str) -> float:
    """MODEL_FLOPS = 6*N*D for train, 2*N*D for inference forward."""
    per_tok = 6.0 if kind == "train" else 2.0
    return per_tok * n_params_active * tokens
