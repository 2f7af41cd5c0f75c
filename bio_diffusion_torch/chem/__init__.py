"""Host-side chemistry: bond tables and stability metrics."""
