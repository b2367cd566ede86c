// A thread's PyTorch thread-local state, carried to another thread.
//
// torch.profiler registers its RecordFunction callbacks and keeps its
// state thread-locally, on the thread that started it, so a plain Python
// worker thread records nothing into a running profile.  at::launch carries
// the state across with at::ThreadLocalState / ThreadLocalStateGuard; this
// file gives the executor's worker pools the same two calls through a plain
// C interface (loaded with ctypes, see runtime/trace.py):
//
//   state = ct_tls_capture()     on the submitting thread
//   guard = ct_tls_enter(state)  on the worker, before the task
//   ct_tls_exit(guard)           on the worker, after it (restores the
//                                worker's own state)
//   ct_tls_free(state)           once no task will enter it again
//
// A state may be entered by several workers at once: entering copies it.

#include <ATen/ThreadLocalState.h>

extern "C" {

void* ct_tls_capture() { return new at::ThreadLocalState(); }

void ct_tls_free(void* state) { delete static_cast<at::ThreadLocalState*>(state); }

void* ct_tls_enter(void* state) {
  return new at::ThreadLocalStateGuard(*static_cast<const at::ThreadLocalState*>(state));
}

void ct_tls_exit(void* guard) { delete static_cast<at::ThreadLocalStateGuard*>(guard); }

}  // extern "C"
