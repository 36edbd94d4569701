"""Optimizers for the port's trainers (the Adam slice of ``repro.train``)."""
