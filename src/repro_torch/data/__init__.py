"""Synthetic table generators (copies of the reference's ``repro.data``)."""
