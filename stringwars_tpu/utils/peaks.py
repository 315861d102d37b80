"""Published device-memory peaks, keyed by the exact ``device_kind`` string.

The report's SoL column divides a row's byte rate by this peak. Source:
NVIDIA H100 Tensor Core GPU data sheet, SXM form factor: 80 GB HBM3 at
3.35 TB/s. Other H100 parts report other ``device_kind`` strings ("NVIDIA
H100 PCIe", "NVIDIA H100 NVL") and have other peaks, so the match is
exact and a device missing from the table is an error, never a default.
"""

from __future__ import annotations

HBM_PEAK_BYTES_PER_SECOND = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_peak_bytes_per_second(device_kind: str) -> float:
    """Published memory bandwidth of ``device_kind`` in bytes/s."""
    try:
        return HBM_PEAK_BYTES_PER_SECOND[device_kind]
    except KeyError:
        raise KeyError(
            f"no published memory peak for device_kind {device_kind!r}; "
            f"known: {sorted(HBM_PEAK_BYTES_PER_SECOND)}"
        ) from None
