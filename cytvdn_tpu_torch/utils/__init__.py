"""Host-side utilities: memory advisor, traffic model, state transfer."""
