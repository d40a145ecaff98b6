"""Model families, one module each, found by a configuration file's
``run.family`` (``spec.family``) under the benchmark's root, as drivers
are found by their traffic kind.  A configuration whose architecture no
family here knows brings its own module as a new file.

A family module gives:

* ``spec_of(config)``: its frozen spec, a subclass of ``spec.Spec`` (the
  fields every driver and reader uses) defined in the module, with what
  the family needs besides; ``spec.family_of`` finds the module again by
  that class;
* ``program_checks(spec, run)``: {the program's ``ModelConfig``
  attribute: the value the file says}, which ``spec.program_config``
  holds the program to;
* ``param_shapes(spec)``: every leaf's shape by dotted name, the
  program's checkpoint layout; ``fan_in(spec, name)``: the fan-in of a
  leaf drawn by ``weights.draw``'s normal law; optionally ``LAWS``:
  {leaf: law(spec, shape, generator, device)} for a leaf of its own;
* ``hidden(spec, num, P, tokens, remat)``: the plain fp32 forward to the
  final norm, from ``reference.model``'s library; a family that decodes
  through a KV cache also ``decode_over_prefix``;
* ``matmul_params(spec)`` and ``model_flops(spec, batch, seq, train)``;
  a family that decodes through a KV cache also ``decode_bytes``.
"""
