"""Accelerator discovery and properties from ``torch.cuda``.

The counterpart of ``wfa_tpu/utils/device_query.py`` (and of the reference's
utils/device_query.cu): device count, name, SM count, shared memory a block
may use, and device memory.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    platform: str            # "gpu" or "cpu"
    device_kind: str         # e.g. "NVIDIA H100 80GB HBM3"
    num_devices: int
    sm_count: int | None
    smem_per_block: int | None   # bytes a block may opt in to, when known
    hbm_bytes: int | None


def query_devices() -> DeviceInfo:
    if not torch.cuda.is_available():
        return DeviceInfo("cpu", "cpu", 0, None, None, None)
    p = torch.cuda.get_device_properties(0)
    return DeviceInfo(
        platform="gpu",
        device_kind=p.name,
        num_devices=torch.cuda.device_count(),
        sm_count=p.multi_processor_count,
        smem_per_block=getattr(
            p, "shared_memory_per_block_optin", p.shared_memory_per_block
        ),
        hbm_bytes=p.total_memory,
    )


def describe() -> str:
    info = query_devices()
    if info.platform == "cpu":
        return "no CUDA device; the torch engine runs on the CPU"
    return (
        f"{info.num_devices} gpu device(s) [{info.device_kind}], "
        f"{info.sm_count} SMs, {info.smem_per_block} B shared memory per "
        f"block, {info.hbm_bytes / 2**30:.1f} GiB device memory"
    )
