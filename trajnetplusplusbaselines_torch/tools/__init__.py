"""Dataset, evaluation and profiling tools of the port, copied from
``trajnetplusplusbaselines_tpu.tools``: ``create_validation``, ``get_dest``,
``collect_results``, ``collision_gate``, ``profile_train``, ``plot_log`` and
``visualize_predictions`` (the last two need matplotlib), and
``eval_reference_checkpoint``, which scores a checkpoint of the reference
implementation with the port's evaluator (``reference_stub`` imports the
reference)."""
