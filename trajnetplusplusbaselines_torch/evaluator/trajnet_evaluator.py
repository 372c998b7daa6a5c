"""TrajNet++ evaluation harness.

Copy of ``trajnetplusplusbaselines_tpu/evaluator/trajnet_evaluator.py``:
per-scene ADE/FDE, ground-truth collisions (Col-II), prediction collisions
(Col-I, with the -1 sentinel when a model does not predict every
neighbour), top-k ADE/FDE for multimodal models, KDE NLL for >48 modes,
aggregated overall and per scene type (static / linear /
forced-non-linear / non-linear) and interaction subtype (LF / CA / group /
others), plus the synthetic collision_test Pass/Fail gate.
"""

import os
from collections import defaultdict

from ..data import Reader
from ..metrics import Categories, Metrics, SubCategories
from ..metrics import trajectory as tmetrics
from .design_table import Table


class TrajnetEvaluator:
    def __init__(self, scenes_gt, scenes_id_gt, scenes_pred, indexes, sub_indexes, args):
        self.scenes_gt = scenes_gt
        self.scenes_id_gt = scenes_id_gt
        self.scenes_pred = scenes_pred
        self.indexes = indexes
        self.sub_indexes = sub_indexes

        self.metrics = Metrics(len(scenes_gt))
        self.categories = Categories(*[Metrics(len(indexes[i])) for i in range(1, 5)])
        self.sub_categories = SubCategories(*[Metrics(len(sub_indexes[i])) for i in range(1, 5)])

        num_predictions = 0
        for track in self.scenes_pred[0][0]:
            if track.prediction_number and track.prediction_number > num_predictions:
                num_predictions = track.prediction_number
        self.num_predictions = num_predictions

        self.pred_length = args.pred_length
        self.obs_length = args.obs_length
        self.disable_collision = getattr(args, "disable_collision", False)
        self.enable_col1 = True

    @staticmethod
    def drop_post_obs(ground_truth, obs_length):
        """Drop GT tracks that first appear after the observation window."""
        obs_end_frame = ground_truth[0][obs_length].frame
        return [track for track in ground_truth if track[0].frame < obs_end_frame]

    def aggregate(self):
        score = {i: Metrics(0) for i in range(1, 5)}
        sub_score = {i: Metrics(0) for i in range(1, 5)}
        average = final = avg_topk_ade = avg_topk_fde = avg_nll = 0.0

        for i in range(len(self.scenes_gt)):
            ground_truth = self.scenes_gt[i]
            scene_id = self.scenes_id_gt[i]

            curr_type = next(
                (k for k in score if scene_id in self.indexes[k]), None
            )
            sub_types = [k for k in sub_score if scene_id in self.sub_indexes[k]]

            primary_tracks_all = [t for t in self.scenes_pred[i][0] if t.scene_id == scene_id]
            neighbours_tracks_all = [
                [t for t in self.scenes_pred[i][j] if t.scene_id == scene_id]
                for j in range(1, len(self.scenes_pred[i]))
            ]
            neighbours_tracks_all = [t for t in neighbours_tracks_all if len(t)]

            primary_tracks = [t for t in primary_tracks_all if t.prediction_number == 0]
            neighbours_tracks = [
                [t for t in tracks if t.prediction_number == 0]
                for tracks in neighbours_tracks_all
            ]

            frame_gt = [t.frame for t in ground_truth[0]][-self.pred_length:]
            frame_pred = [t.frame for t in primary_tracks]
            if frame_gt != frame_pred:
                raise Exception(
                    f"frame numbers are not consistent (scene {scene_id}): "
                    f"gt {frame_gt} vs pred {frame_pred}"
                )

            average_l2 = tmetrics.average_l2(
                ground_truth[0], primary_tracks, n_predictions=self.pred_length
            )
            final_l2 = tmetrics.final_l2(ground_truth[0], primary_tracks)

            if curr_type is not None:
                score[curr_type].N += 1
            for st in sub_types:
                sub_score[st].N += 1

            if not self.disable_collision:
                ground_truth = self.drop_post_obs(ground_truth, self.obs_length)
                # Col-II: collisions against ground-truth neighbours
                for j in range(1, len(ground_truth)):
                    if tmetrics.collision(
                        primary_tracks, ground_truth[j], n_predictions=self.pred_length
                    ):
                        self.metrics.gt_col += 1
                        if curr_type is not None:
                            score[curr_type].gt_col += 1
                        for st in sub_types:
                            sub_score[st].gt_col += 1
                        break

                # Col-I: collisions against predicted neighbours; needs every
                # GT neighbour to have a predicted track
                num_gt_neigh = len(ground_truth) - 1
                num_predicted_neigh = len(neighbours_tracks)
                if num_gt_neigh != num_predicted_neigh:
                    self.enable_col1 = False
                    self.metrics.pred_col = -1
                    if curr_type is not None:
                        score[curr_type].pred_col = -1
                    for st in sub_types:
                        sub_score[st].pred_col = -1

                if self.enable_col1:
                    for tracks in neighbours_tracks:
                        if tmetrics.collision(
                            primary_tracks, tracks, n_predictions=self.pred_length
                        ):
                            self.metrics.pred_col += 1
                            if curr_type is not None:
                                score[curr_type].pred_col += 1
                            for st in sub_types:
                                sub_score[st].pred_col += 1
                            break

            average += average_l2
            final += final_l2
            if curr_type is not None:
                score[curr_type].average_l2 += average_l2
                score[curr_type].final_l2 += final_l2
            for st in sub_types:
                sub_score[st].average_l2 += average_l2
                sub_score[st].final_l2 += final_l2

            if self.num_predictions > 1:
                topk_ade, topk_fde = tmetrics.topk(
                    primary_tracks_all, ground_truth[0], n_predictions=self.pred_length
                )
                avg_topk_ade += topk_ade
                avg_topk_fde += topk_fde
                if curr_type is not None:
                    score[curr_type].topk_ade += topk_ade
                    score[curr_type].topk_fde += topk_fde
                for st in sub_types:
                    sub_score[st].topk_ade += topk_ade
                    sub_score[st].topk_fde += topk_fde

            if self.num_predictions > 48:
                nll = tmetrics.nll(
                    primary_tracks_all,
                    ground_truth[0],
                    n_predictions=self.pred_length,
                    n_samples=50,
                )
                avg_nll += nll
                if curr_type is not None:
                    score[curr_type].nll += nll
                for st in sub_types:
                    sub_score[st].nll += nll

        self.metrics.average_l2 = average
        self.metrics.final_l2 = final
        self.metrics.nll = avg_nll
        self.metrics.topk_ade = avg_topk_ade
        self.metrics.topk_fde = avg_topk_fde

        self.categories.static_scenes = score[1]
        self.categories.linear_scenes = score[2]
        self.categories.forced_non_linear_scenes = score[3]
        self.categories.non_linear_scenes = score[4]

        self.sub_categories.lf = sub_score[1]
        self.sub_categories.ca = sub_score[2]
        self.sub_categories.grp = sub_score[3]
        self.sub_categories.others = sub_score[4]

    def result(self):
        return self.metrics, self.categories, self.sub_categories


def collision_test(list_sub, name, args):
    """Synthetic gate: the two collision_test tracks must never collide."""
    submit_datasets = [
        args.path + name + "/" + f for f in list_sub if "collision_test.ndjson" in f
    ]
    if len(submit_datasets):
        reader = Reader(submit_datasets[0], scene_type="paths")
        scenes = [s for _, s in reader.scenes()]
        # collision is judged on the single-mode (prediction_number 0)
        # tracks, consistent with the evaluator's single-mode block
        primary = [t for t in scenes[0][0] if (t.prediction_number or 0) == 0]
        neigh = [t for t in scenes[0][1] if (t.prediction_number or 0) == 0]
        if tmetrics.collision(primary, neigh, n_predictions=args.pred_length):
            return "Fail"
        return "Pass"
    return "NA"


def eval(gt, input_file, args):  # noqa: A001 - name kept for API parity
    reader_gt = Reader(gt, scene_type="paths")
    gt_pairs = list(reader_gt.scenes())  # single parse: (id, scene) pairs
    scenes_gt = [s for _, s in gt_pairs]
    scenes_id_gt = [s_id for s_id, _ in gt_pairs]

    reader_pred = Reader(input_file, scene_type="paths")
    scenes_pred = [s for _, s in reader_pred.scenes()]

    indexes = defaultdict(list)
    sub_indexes = defaultdict(list)
    for scene in reader_gt.scenes_by_id:
        tags = reader_gt.scenes_by_id[scene].tag
        main_type, sub_types = tags[0], tags[1]
        indexes[main_type].append(scene)
        for sub_type in sub_types:
            sub_indexes[sub_type].append(scene)

    evaluator = TrajnetEvaluator(
        scenes_gt, scenes_id_gt, scenes_pred, indexes, sub_indexes, args
    )
    evaluator.aggregate()
    return evaluator.result()


def trajnet_evaluate(args):
    """Evaluate every model's test_pred files against test_private."""
    model_names = [
        model.split("/")[-1].replace(".pkl", "") + "_modes" + str(args.modes)
        for model in args.output
    ]
    labels = args.labels if getattr(args, "labels", None) is not None else model_names
    table = Table()

    for num, model_name in enumerate(model_names):
        print(model_name)
        model_preds = sorted(
            f for f in os.listdir(args.path + model_name) if not f.startswith(".")
        )

        col_result = collision_test(model_preds, model_name, args)
        table.add_collision_entry(labels[num], col_result)

        pred_datasets = [
            args.path + model_name + "/" + f
            for f in model_preds
            if "collision_test.ndjson" not in f
        ]
        true_datasets = [
            args.path.replace("/test_pred/", "/test_private/") + f
            for f in model_preds
            if "collision_test.ndjson" not in f
        ]

        results = {
            pred_datasets[i].replace(args.path, "").replace(".ndjson", ""): eval(
                true_datasets[i], pred_datasets[i], args
            )
            for i in range(len(true_datasets))
        }
        table.add_entry(labels[num], results)

    table.print_table()
    return table
