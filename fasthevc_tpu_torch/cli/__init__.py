"""CLI entry points of the port: `encode`, `decode` and `evaluate`, the
counterparts of `fasthevc_tpu.cli` (HM's TAppEncoder / TAppDecoder
analogs).  The encoders run on the card unless `--device cpu` is given."""
