"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version:

* ``adel_agg`` — the Eq. 5 layer-wise fold (server hot loop);
* ``adel_agg_q8`` — the fused int8 dequantize + weight + accumulate fold;
* ``flash_attention`` — GQA causal / sliding-window attention (LM prefill);
* ``ssd_scan`` — the Mamba2 SSD chunk scan (LM prefill, ssm and hybrid).

CUDA C++ sources live in ``repro_torch/csrc`` and are built with ``nvcc``
on first use (:mod:`repro_torch.kernels.build`).
"""
from repro_torch.kernels.adel_agg import adel_agg, adel_agg_q8
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan

__all__ = ["adel_agg", "adel_agg_q8", "flash_attention", "ssd_scan"]
