"""Topologies by name (``"topology": {"kind": <name>, ...}`` in a
configuration): ``<name>.py`` gives ``program(**params)``, the program's
own topology as a user builds it, and ``neighbours(**params)``, the
neighbour lists the plain reference routes by (a frozen copy)."""
