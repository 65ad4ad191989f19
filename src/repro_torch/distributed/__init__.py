"""Host-side fault-tolerance helpers (copies of ``repro/distributed``)."""
