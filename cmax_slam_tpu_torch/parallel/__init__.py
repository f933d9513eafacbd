"""Batched and multi-device modes: throughput tracking over lanes, the
event-sharded window objective and the segmented replay. A device list
(``["cuda:0", "cuda:1"]``, or ``["cuda:0", "cuda:0"]`` on one card) plays the
role of the JAX package's mesh; one host process drives every device."""
