"""Host orchestration of the port: intra search glue and the encoder top.
Counterparts of `fasthevc_tpu.codec.search` and `fasthevc_tpu.codec.encoder`."""
