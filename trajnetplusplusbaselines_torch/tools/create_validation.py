"""Scene-level dataset splitter.

Port of ``trajnetplusplusbaselines_tpu/tools/create_validation.py`` (no jax
there or here: the same ``random.Random(seed)`` draw per scene row, so the
same ``--seed`` writes the same split, byte for byte).  A train/val split of
scene rows, all tracks duplicated, with an optional test/test_private split
so the full predict -> evaluate loop can run on datasets that ship only a
train set.  ``test`` and ``test_private`` both carry all track rows;
observation truncation happens in the evaluator's preprocess_test, as with
the official TrajNet++ test files.

Usage:
    python -m trajnetplusplusbaselines_torch.tools.create_validation \
        --path trajdata --val_ratio 0.2 --test_ratio 0.1
"""

import argparse
import os
import random


def split_file(src: str, dest_root: str, name: str, val_ratio: float,
               test_ratio: float, rng: random.Random) -> None:
    with open(src, "r") as f:
        lines = f.readlines()

    subsets = ["train", "val"] + (["test", "test_private"] if test_ratio > 0 else [])
    handles = {
        s: open(os.path.join(dest_root, s, name + ".ndjson"), "w") for s in subsets
    }
    try:
        for line in lines:
            if '"scene"' in line:
                u = rng.random()
                if u < val_ratio:
                    handles["val"].write(line)
                elif test_ratio > 0 and u < val_ratio + test_ratio:
                    handles["test"].write(line)
                    handles["test_private"].write(line)
                else:
                    handles["train"].write(line)
                continue
            for h in handles.values():
                h.write(line)
    finally:
        for h in handles.values():
            h.close()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--path", default="trajdata")
    parser.add_argument("--val_ratio", default=0.2, type=float)
    parser.add_argument("--test_ratio", default=0.0, type=float,
                        help="additionally carve out test/test_private scenes")
    parser.add_argument("--seed", default=42, type=int)
    parser.add_argument("--data_root", default="DATA_BLOCK",
                        help="root holding <path>/train (may be read-only)")
    parser.add_argument("--output_root", default="DATA_BLOCK")
    args = parser.parse_args(argv)

    rng = random.Random(args.seed)
    src_dir = os.path.join(args.data_root, args.path, "train")
    dest_root = os.path.join(args.output_root, args.path + "_split")

    subsets = ["train", "val"] + (["test", "test_private"] if args.test_ratio > 0 else [])
    for s in subsets:
        os.makedirs(os.path.join(dest_root, s), exist_ok=True)

    files = [f[: -len(".ndjson")] for f in sorted(os.listdir(src_dir)) if f.endswith(".ndjson")]
    print(files)
    for name in files:
        split_file(
            os.path.join(src_dir, name + ".ndjson"),
            dest_root, name, args.val_ratio, args.test_ratio, rng,
        )
    print(f"wrote {dest_root} ({', '.join(subsets)})")


if __name__ == "__main__":
    main()
