"""Entry points: the hedged serving loop (``serve``)."""
