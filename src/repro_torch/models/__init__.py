"""The model zoo, served and trained: the dense transformer
(``transformer``), and the pure Mamba2 and Zamba2-style hybrid LMs
(``mamba2``, ``ssm_lm``), behind one dispatch (``api``)."""
