"""Serving driver and its paged KV-cache bookkeeping — counterpart of
`repro.launch` (single device)."""
