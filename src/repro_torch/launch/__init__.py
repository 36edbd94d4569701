"""Launch layer of the port: the serving entry point
(``python -m repro_torch.launch.serve``) and the training launcher
(``python -m repro_torch.launch.train``).  The reference's mesh
factory and dry-run entry point wait for ROADMAP item M12d."""
