"""Input pipeline of the port: COCO records, augmentation sampling and the
device-warp batch collate (counterparts of stlpose_tpu/data)."""
