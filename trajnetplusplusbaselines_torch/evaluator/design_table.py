"""Results table: aggregate per-dataset metrics and render them.

Copy of ``trajnetplusplusbaselines_tpu/evaluator/design_table.py``: per
model, 8 averaged metric values for each of the four scene types, the
overall block and the four interaction subtypes (LF / CA / Grp / Others),
as a plain-text table on stdout and a Results.png.
"""

import os
from typing import Dict, List

from ..metrics import Categories, Metrics, SubCategories

COLUMNS = ["No.", "ADE", "FDE", "Col I", "Col II", "Top3 ADE", "Top3 FDE", "NLL"]
TYPE_BLOCKS = [
    ("I (static)", "results", 0),
    ("II (linear)", "results", 8),
    ("III (interacting)", "results", 16),
    ("III: LF", "sub_results", 0),
    ("III: CA", "sub_results", 8),
    ("III: Grp", "sub_results", 16),
    ("III: Others", "sub_results", 24),
    ("IV (non-interacting)", "results", 24),
    ("Overall", "results", 32),
]


class Table:
    def __init__(self, arg=None):
        self.arg = arg
        self.results: Dict[str, List[float]] = {}
        self.sub_results: Dict[str, List[float]] = {}
        self.collision_test: Dict[str, str] = {}

    def add_collision_entry(self, name: str, result: str) -> None:
        self.collision_test[name] = result

    def add_entry(self, name: str, results: dict):
        """Sum each dataset's records, then average into display values."""
        table_metrics = Metrics(0)
        table_categories = Categories(*[Metrics(0) for _ in range(4)])
        table_sub = SubCategories(*[Metrics(0) for _ in range(4)])

        for _, (metrics, categories, sub_categories) in results.items():
            table_metrics += metrics
            table_categories.static_scenes += categories.static_scenes
            table_categories.linear_scenes += categories.linear_scenes
            table_categories.forced_non_linear_scenes += categories.forced_non_linear_scenes
            table_categories.non_linear_scenes += categories.non_linear_scenes
            table_sub.lf += sub_categories.lf
            table_sub.ca += sub_categories.ca
            table_sub.grp += sub_categories.grp
            table_sub.others += sub_categories.others

        final_results = (
            table_categories.static_scenes.avg_vals_to_list()
            + table_categories.linear_scenes.avg_vals_to_list()
            + table_categories.forced_non_linear_scenes.avg_vals_to_list()
            + table_categories.non_linear_scenes.avg_vals_to_list()
            + table_metrics.avg_vals_to_list()
        )
        sub_final_results = (
            table_sub.lf.avg_vals_to_list()
            + table_sub.ca.avg_vals_to_list()
            + table_sub.grp.avg_vals_to_list()
            + table_sub.others.avg_vals_to_list()
        )
        self.results[name] = final_results
        self.sub_results[name] = sub_final_results
        return final_results, sub_final_results

    def add_result(self, name, final_results, sub_final_results):
        self.results[name] = final_results
        self.sub_results[name] = sub_final_results

    # ----------------------------------------------------------------- print
    def as_text(self) -> str:
        lines = []
        header = f"{'Block':<22}{'Model':<22}" + "".join(f"{c:>10}" for c in COLUMNS) + f"{'Col_test':>10}"
        lines.append(header)
        lines.append("-" * len(header))
        for block_name, attr, start in TYPE_BLOCKS:
            store = getattr(self, attr)
            for model, vals in store.items():
                row = vals[start : start + 8]
                cells = "".join(
                    f"{v:>10.2f}" if isinstance(v, float) else f"{v:>10}" for v in row
                )
                col_test = self.collision_test.get(model, "NA") if block_name == "Overall" else ""
                lines.append(f"{block_name:<22}{model[:20]:<22}{cells}{col_test:>10}")
        return "\n".join(lines)

    def print_table(self, output_file: str = "Results.png") -> None:
        text = self.as_text()
        print(text)
        self.save_png(output_file)

    def save_png(self, output_file: str = "Results.png") -> None:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return

        rows = []
        for block_name, attr, start in TYPE_BLOCKS:
            store = getattr(self, attr)
            for model, vals in store.items():
                row = [block_name, model[:14]] + [
                    f"{v:.2f}" if isinstance(v, float) else str(v)
                    for v in vals[start : start + 8]
                ]
                row.append(self.collision_test.get(model, "NA") if block_name == "Overall" else "")
                rows.append(row)

        fig, ax = plt.subplots(figsize=(16, 0.4 * len(rows) + 1))
        ax.axis("off")
        table = ax.table(
            cellText=rows,
            colLabels=["Block", "Model"] + COLUMNS + ["Col_test"],
            cellLoc="center",
            loc="center",
        )
        table.auto_set_font_size(False)
        table.set_fontsize(9)
        fig.savefig(output_file, bbox_inches="tight", dpi=120)
        plt.close(fig)
