"""The plain reference: fp32 PyTorch with TF32 off, no kernel, no cache
manager, no batching, written from the models' equations and importing
nothing of the program.  ``numerics`` also gives the control: the same
reference with every matrix product's operands rounded to fp8 (e4m3), the
precision below the configuration's bf16 compute."""
