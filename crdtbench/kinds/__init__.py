"""Mix kinds by name (``"kind"`` in ``mixes/<traffic>.json``). Each
``<kind>.py`` gives

* ``entry(mix, config, seed)``: one pool entry's inputs from its seed;
* ``build(config, mix, pool, devices)``: a :class:`crdtbench.program.Cell`
  whose calls run the program on those inputs as a user calls it;
* ``reference(config, mix, entry, devices, drop=None)``: the plain
  reference's answer in the layout of :func:`crdtbench.program.answer`
  (``drop`` breaks delivery: the control);
* ``judge(config, mix, entry, ans, devices)``: the numbers compared.
"""
