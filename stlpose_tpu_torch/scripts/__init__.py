"""The numbered CLI scripts of the port (counterparts of scripts/01-03).
Each runs as a file or in-process through its ``main(argv)``:
``importlib.import_module("stlpose_tpu_torch.scripts.02_train").main([...])``."""
