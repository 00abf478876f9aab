"""ASCII report tables in the reference's output format (ref:06:86-93,
ref:18:72-79) and a simple throughput counter.

The port's own copy of ``tsr_tpu/utils/reporting.py``: the same strings
for the same inputs. The scripts print :func:`accuracy_report`;
:func:`metric_report` and :class:`Throughput` have no caller in either
package's scripts and are kept for library users.
"""

from __future__ import annotations

import time
from typing import Dict, Optional


def accuracy_report(results: Dict[str, float], title: str) -> str:
    """Aligned accuracy table (ref:06:86-93)."""
    lines = ["=" * 30, title, "=" * 30,
             f"{'Dataset':<20} | {'Accuracy':<10}", "-" * 32]
    for name, acc in results.items():
        lines.append(f"{name:<20} | {acc * 100:.2f}%")
    lines.append("=" * 30)
    return "\n".join(lines)


def metric_report(results: Dict[str, Dict[str, float]], title: str) -> str:
    """Multi-metric table (PSNR/SSIM style, ref:08:132-135)."""
    keys = sorted({k for v in results.values() for k in v})
    header = f"{'Dataset':<20} | " + " | ".join(f"{k:>10}" for k in keys)
    lines = ["=" * len(header), title, "=" * len(header), header,
             "-" * len(header)]
    for name, metrics in results.items():
        row = f"{name:<20} | " + " | ".join(
            f"{metrics.get(k, float('nan')):>10.4f}" for k in keys)
        lines.append(row)
    lines.append("=" * len(header))
    return "\n".join(lines)


class Throughput:
    """images/sec counter with warmup exclusion."""

    def __init__(self, warmup_batches: int = 1):
        self.warmup = warmup_batches
        self.n_batches = 0
        self.n_images = 0
        self.t0: Optional[float] = None

    def tick(self, batch_size: int):
        self.n_batches += 1
        if self.n_batches == self.warmup:
            self.t0 = time.perf_counter()
            return
        if self.n_batches > self.warmup:
            self.n_images += batch_size

    @property
    def images_per_sec(self) -> float:
        if self.t0 is None or self.n_images == 0:
            return float("nan")
        return self.n_images / (time.perf_counter() - self.t0)
