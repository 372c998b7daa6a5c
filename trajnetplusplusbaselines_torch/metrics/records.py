"""Metric accumulation records of the TrajNet++ evaluator.

Copy of ``trajnetplusplusbaselines_tpu/metrics/records.py``, with the -1
sentinel of Col-I (set when a model does not predict all neighbours) and
collision rates in percent.
"""

from dataclasses import dataclass


@dataclass
class Metrics:
    N: int
    average_l2: float = 0.0
    final_l2: float = 0.0
    gt_col: float = 0.0
    pred_col: float = 0.0
    topk_ade: float = 0.0
    topk_fde: float = 0.0
    nll: float = 0.0

    def __iadd__(self, other: "Metrics") -> "Metrics":
        self.N += other.N
        self.average_l2 += other.average_l2
        self.final_l2 += other.final_l2
        self.gt_col += other.gt_col
        if other.pred_col == -1 or self.pred_col == -1:
            self.pred_col = -1
        else:
            self.pred_col += other.pred_col
        self.topk_ade += other.topk_ade
        self.topk_fde += other.topk_fde
        self.nll += other.nll
        return self

    def avg_vals(self) -> None:
        """Normalize sums to means; collision counts become percentages."""
        if self.N == 0:
            return
        self.average_l2 /= self.N
        self.final_l2 /= self.N
        self.gt_col /= 0.01 * self.N
        if self.pred_col != -1:
            self.pred_col /= 0.01 * self.N
        self.topk_ade /= self.N
        self.topk_fde /= self.N
        self.nll /= self.N

    def to_list(self):
        return [
            self.N,
            self.average_l2,
            self.final_l2,
            self.pred_col,
            self.gt_col,
            self.topk_ade,
            self.topk_fde,
            self.nll,
        ]

    def avg_vals_to_list(self):
        self.avg_vals()
        return self.to_list()


@dataclass
class Categories:
    static_scenes: Metrics
    linear_scenes: Metrics
    forced_non_linear_scenes: Metrics
    non_linear_scenes: Metrics


@dataclass
class SubCategories:
    lf: Metrics
    ca: Metrics
    grp: Metrics
    others: Metrics
