"""Launch layer of the port: the serving entry point
(``python -m repro_torch.launch.serve``).  The reference's mesh
factory, dry-run entry point and training launcher belong to the LM
substrate and are not ported yet (ROADMAP item M12)."""
