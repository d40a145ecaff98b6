"""The model zoo's serving path: dense transformer (``transformer``) and
pure Mamba2 (``mamba2``, ``ssm_lm``) LMs behind one dispatch (``api``)."""
