"""CPU tests of the benchmark (``pytest benchmark/tests -q``); the tests
marked ``cuda`` run on a card and skip without one."""
