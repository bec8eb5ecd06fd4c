"""The seeded graph generator and the traffic mixes it reads
(``<name>.json``)."""
