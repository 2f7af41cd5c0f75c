"""CPU tests of the benchmark, and its tests that need the card (marked ``cuda``)."""
