"""Entry points: the hedged serving loop (``serve``), the coded training
loop (``train``) and the train, prefill and decode cells (``steps``)."""
