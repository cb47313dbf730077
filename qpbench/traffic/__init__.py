"""Fleet generators, frozen copies of the port's problems/device_fleet.py
and problems/prox_fleet.py that import nothing of the port: each ``fleet``
returns a dict of tensors made on ``generator.device`` from that generator
alone, and each ``orient`` turns a fleet's lanes by signs drawn from a
generator, which changes their bits and not their work."""
