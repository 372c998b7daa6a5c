"""CLI: evaluate trained SGAN models with the port.

Port of ``trajnetplusplusbaselines_tpu/evaluator/sgan_cli.py``: the model is
told apart when its pickle loads, so this is the shared driver of
``lstm_cli``, with its flags (``--modes``, ``--device``, default ``cuda``),
kept for command-line parity; under ``torch.distributed.run`` its ranks
share the test datasets as ``lstm_cli``'s do.

Usage:
    python -m trajnetplusplusbaselines_torch.evaluator.sgan_cli \
        --path trajdata_split --output OUTPUT_BLOCK/trajdata_split/sgan_directional.pkl --modes 3
"""

from .lstm_cli import main

if __name__ == "__main__":
    main()
