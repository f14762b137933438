"""Entry points above ``train/``, ``meshing/`` and ``features/``.

* ``scale_train``: the at-scale training run over the full schedule, with
  checkpoints, a resume that truncates the history, and a summary;
* ``mesh_eval``: a TSDF mesh of an analytic-scene checkpoint, its accuracy
  and completeness against the scene's exact surfaces;
* ``feature_chain_eval``: a rade-features checkpoint through TSDF with
  latent transfer, a decode and a text query;
* ``reference_run``: the reference configuration's run with a kill and a
  resume, then the two evaluations.

Each runs as ``python -m collab_splats_tpu_torch.scripts.<name>`` on the
card, or on the CPU with ``--cpu``.
"""
