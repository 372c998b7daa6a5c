"""Dataset, evaluation and profiling tools of the port, copied from
``trajnetplusplusbaselines_tpu.tools``: ``create_validation``, ``get_dest``,
``collect_results``, ``collision_gate``, ``profile_train``, ``plot_log`` and
``visualize_predictions`` (the last two need matplotlib).
``eval_reference_checkpoint`` waits for the reference implementation to be
in the repository."""
