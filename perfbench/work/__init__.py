"""The yardstick, frozen with the benchmark: each kernel function's
operations and bytes (``formulas``), the H100's published peaks
(``peaks``), a step's model FLOPs (``model_flops``) and CUDA-event timing
(``timing``). None of it imports the port: a later change to the port's
own counts cannot move a roofline share or an MFU read here."""
