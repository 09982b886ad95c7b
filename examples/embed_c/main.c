/* C host embedding the JAX ocean framework.
 *
 * The reference ships an iOS embedding: a C-ABI `run_app()` exported from
 * a Rust staticlib, driven by an Obj-C host (examples/ios/ios.rs:3-6,
 * examples/ios/src/main.m:10-12). The analog here is a C host that
 * embeds CPython, initializes the framework, runs simulation steps, and
 * reads back a field checksum — the pattern for wiring the engine into a
 * native serving process.
 *
 * Build & run:  make -C examples/embed_c run
 */

#include <Python.h>
#include <stdio.h>

static const char *kProgram =
    "import numpy as np\n"
    "import jax.numpy as jnp\n"
    "import gfx_ocean_tpu as ot\n"
    "state = ot.ocean_state_from_assets()\n"
    "step = ot.make_step(ot.OceanConfig(compute_normals=False))\n"
    "def run_frame(t):\n"
    "    out = step(state, jnp.float32(t))\n"
    "    return float(np.asarray(out.displacement).sum())\n";

int run_app(int frames) {
  Py_Initialize();

  PyObject *globals = PyDict_New();
  PyDict_SetItemString(globals, "__builtins__", PyEval_GetBuiltins());
  PyObject *init = PyRun_String(kProgram, Py_file_input, globals, globals);
  if (!init) {
    PyErr_Print();
    return 1;
  }
  Py_DECREF(init);

  PyObject *run_frame = PyDict_GetItemString(globals, "run_frame");
  for (int i = 0; i < frames; ++i) {
    PyObject *res =
        PyObject_CallFunction(run_frame, "d", (double)i / 60.0);
    if (!res) {
      PyErr_Print();
      return 1;
    }
    printf("frame %d checksum %.6f\n", i, PyFloat_AsDouble(res));
    Py_DECREF(res);
  }

  Py_DECREF(globals);
  return Py_FinalizeEx() < 0 ? 1 : 0;
}

int main(void) { return run_app(3); }
