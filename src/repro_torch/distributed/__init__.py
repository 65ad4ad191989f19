"""The port of ``repro/distributed``: the straggler watchdog, the sharded
leaves and collectives of the data axes (``sharding``) and the int8
gradient compression library (``compression``)."""
