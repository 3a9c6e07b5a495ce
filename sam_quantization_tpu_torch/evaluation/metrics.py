"""Quality metrics: IoU, Click@k aggregation, NoC (number-of-clicks).

The port's copy of ``sam_quantization_tpu/evaluation/metrics.py`` (numpy
only). Counterparts of script/evaluation2.py:156-167 (get_iou),
fq_vit/test_quant.py:503-519 (AverageMeter), and
inference/utils.py:79-96 (compute_noc_metric).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def get_iou(gt_mask: np.ndarray, pred_mask: np.ndarray, ignore_label: int = -1) -> float:
    """Binary IoU with optional ignore label (ref evaluation2.py:156-167)."""
    ignore = gt_mask == ignore_label
    obj = (gt_mask > 0) & ~ignore
    pred = pred_mask.astype(bool) & ~ignore
    union = (obj | pred).sum()
    if union == 0:
        return 1.0
    return float((obj & pred).sum() / union)


class AverageMeter:
    """Running average (ref fq_vit/test_quant.py:503-519)."""

    def __init__(self, name: str = "", fmt: str = ":f"):
        self.name, self.fmt = name, fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    def __str__(self):
        return f"{self.name} {self.val:.4f} ({self.avg:.4f})"


def compute_noc_metric(
    all_ious: Sequence[np.ndarray], iou_thrs: Sequence[float], max_clicks: int = 20
):
    """NoC@τ: mean clicks to reach each IoU threshold + #failures
    (ref inference/utils.py:79-96)."""

    def _thr_clicks(ious, thr):
        vals = np.nonzero(np.asarray(ious) >= thr)[0]
        return vals[0] + 1 if len(vals) > 0 else max_clicks + 1

    noc_list: List[float] = []
    over_max_list: List[int] = []
    for thr in iou_thrs:
        clicks = np.array(
            [_thr_clicks(ious, thr) for ious in all_ious], dtype=np.int32
        )
        noc_list.append(float(clicks.mean()))
        over_max_list.append(int((clicks > max_clicks).sum()))
    return noc_list, over_max_list


def results_table(
    noc_list, over_max_list, dataset_name, mean_spc, elapsed, n_samples,
    iou_thrs=(0.80, 0.85, 0.90), max_clicks=20,
) -> str:
    """Console table (ref inference/utils.py:122-142 capability)."""
    header = (
        f"|{'Dataset':^15}|"
        + "".join(f"{'NoC@%d%%' % int(t * 100):^9}|" for t in iou_thrs)
        + f"{'>=' + str(max_clicks) + '@' + str(int(iou_thrs[-1]*100)) + '%':^9}|"
        + f"{'SPC,s':^7}|{'Time':^9}|"
    )
    row = (
        f"|{dataset_name:^15}|"
        + "".join(f"{noc:^9.2f}|" for noc in noc_list)
        + f"{over_max_list[-1]:^9}|"
        + f"{mean_spc:^7.3f}|{elapsed:^9.1f}|"
    )
    return "\n".join(["-" * len(header), header, "-" * len(header), row, "-" * len(header)])
