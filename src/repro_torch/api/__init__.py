"""The port's query-layer types (only ``plan.ExplainStats`` so far)."""
