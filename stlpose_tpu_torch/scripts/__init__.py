"""The CLI scripts of the port (counterparts of scripts/01-04 and the
style scripts aux_train_adain_decoder, aux_create_offline_perceptual_loss
and aux_styled_coco_preload).
Each runs as a file or in-process through its ``main(argv)``:
``importlib.import_module("stlpose_tpu_torch.scripts.02_train").main([...])``."""
