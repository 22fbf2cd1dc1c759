"""Host orchestration of the port: search glue, the device pipelines, the
GOP helpers and the encoder top.  Counterparts of `fasthevc_tpu.codec`."""
