"""Raw weights drawn from the seed, and the port's model built on them: one
module per configuration family (``configs/<config>.json``'s
``family``), each with ``draw(config, seed, device)`` and
``build(raw, config)``."""
