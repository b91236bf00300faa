"""Host-side helpers of the PyTorch port: run timing and per-level stats."""
