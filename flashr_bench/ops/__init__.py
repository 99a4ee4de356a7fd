"""The calls a traffic mix makes, one file each, found by name.

Each module gives:

- ``work(cfg, sizes, params)``: the bytes, float32 operations and passes
  one completed call must at least read and perform, counted from the
  call's parameters and the configuration's shapes (``sizes``: the bytes of
  one read of each input), never from the program's counters;
- ``draw(spec, rng, ordinal)``: the call's own parameters, drawn from the
  run's seed (``rng``) or picked by the call's ordinal among the run's calls
  of the operation, so that no two calls of a run get the same inputs;
- ``call(ctx, params)``: the program's call, returning its answer;
- ``stage(ctx, params)``, optional: more of the program's answers to the
  same call, read after the window (``kmeans.py``);
- ``reference(ref, params, prec)``: what the answer is compared with, from
  the plain reference;
- ``control(ref, params, prec)``, optional: the control's answer in the
  program's place, where ``reference`` does not give it;
- ``compare(ans, ref_ans, ref, params)``: the numbers compared, by name.
"""
