"""AutoML: random search over the layer library, trials as subprocesses
of ``glam_tpu_torch.run``, ranking from their logs, high-fidelity reruns
of the top configurations, blending of their checkpoints and PASP
(``solver.GLAM``)."""
