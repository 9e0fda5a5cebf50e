// Host input-staging ring: the native data plane of the dispatcher.  A
// copy of the JAX package's defer_tpu/_native/staging.cpp, with the same
// code; built with g++ at first use by defer_tpu_torch/ops/_build.py.
//
// Role parity: the reference's compute node stages incoming activations in
// a bounded queue between its socket thread and its predict thread
// (reference src/node.py:80-91, Queue(1000) at src/node.py:114); its
// dispatcher feeds the chain from a Python loop one message at a time
// (src/dispatcher.py:90-93).  Both sides pay a Python-object hop per
// sample.  Here the hot path is native: producers memcpy samples into
// preallocated aligned slots (no allocation, no GIL between samples — the
// Python binding releases it around the blocking call), and the consumer
// drains a whole pipeline chunk as ONE contiguous block laid out exactly
// like the SPMD engine's [chunk, microbatch, buf_elems] device buffer, so
// the subsequent host-to-device copy is a single straight copy.
//
// Concurrency: one mutex + two condvars (slots-free / items-ready), MPSC
// capable. close() wakes everyone; pops after close drain the remaining
// backlog then report end-of-stream.  All waits are bounded (timeout_ms) so a
// stalled peer can never wedge the host runtime (the failure mode the
// reference's blocking socket loops have, SURVEY.md §5).

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

struct Ring {
  int64_t slot_bytes;
  int64_t n_slots;
  std::vector<uint8_t> buf;     // n_slots * slot_bytes, single allocation
  std::vector<int64_t> fill;    // bytes actually written per slot
  int64_t head = 0;             // next slot to pop
  int64_t count = 0;            // occupied slots
  bool closed = false;
  std::mutex mu;
  std::condition_variable can_push;
  std::condition_variable can_pop;

  Ring(int64_t sb, int64_t ns)
      : slot_bytes(sb), n_slots(ns),
        buf(static_cast<size_t>(sb * ns)), fill(static_cast<size_t>(ns), 0) {}

  uint8_t* slot(int64_t idx) {
    return buf.data() + (idx % n_slots) * slot_bytes;
  }
};

}  // namespace

extern "C" {

// Create a ring of n_slots slots of slot_bytes each.  Returns an opaque
// handle (never null for sane sizes; null on overflow-ish inputs).
void* staging_create(int64_t slot_bytes, int64_t n_slots) {
  if (slot_bytes <= 0 || n_slots <= 0 ||
      slot_bytes > (int64_t(1) << 40) / n_slots) {
    return nullptr;
  }
  return new Ring(slot_bytes, n_slots);
}

void staging_destroy(void* h) { delete static_cast<Ring*>(h); }

// Copy one sample (n <= slot_bytes) into the next free slot; short samples
// are zero-padded to slot_bytes (the homogeneous-buffer padding the SPMD
// engine otherwise does in Python).  Blocks while the ring is full.
// Returns 1 on success, 0 on timeout, -1 if closed or n > slot_bytes.
int staging_push(void* h, const uint8_t* src, int64_t n, int64_t timeout_ms) {
  Ring* r = static_cast<Ring*>(h);
  if (n < 0 || n > r->slot_bytes) return -1;
  std::unique_lock<std::mutex> lk(r->mu);
  if (!r->can_push.wait_for(lk, std::chrono::milliseconds(timeout_ms), [&] {
        return r->count < r->n_slots || r->closed;
      })) {
    return 0;
  }
  if (r->closed) return -1;
  int64_t idx = r->head + r->count;
  uint8_t* dst = r->slot(idx);
  std::memcpy(dst, src, static_cast<size_t>(n));
  if (n < r->slot_bytes) {
    std::memset(dst + n, 0, static_cast<size_t>(r->slot_bytes - n));
  }
  r->fill[idx % r->n_slots] = n;
  r->count++;
  lk.unlock();
  r->can_pop.notify_one();
  return 1;
}

// Drain up to `want` slots into `dst` (want * slot_bytes bytes), zero-
// filling unpopped tail slots — dst comes back laid out as a full
// [want, slot_bytes] chunk block regardless of how many samples were
// ready.  Blocks until at least one sample (or close/timeout).
// Returns: number of samples popped (>=1), 0 on timeout, -1 on
// end-of-stream (closed and drained).
int64_t staging_pop_block(void* h, uint8_t* dst, int64_t want,
                          int64_t timeout_ms) {
  Ring* r = static_cast<Ring*>(h);
  std::unique_lock<std::mutex> lk(r->mu);
  if (!r->can_pop.wait_for(lk, std::chrono::milliseconds(timeout_ms), [&] {
        return r->count > 0 || r->closed;
      })) {
    return 0;
  }
  if (r->count == 0) return -1;  // closed and drained
  int64_t got = r->count < want ? r->count : want;
  for (int64_t i = 0; i < got; ++i) {
    std::memcpy(dst + i * r->slot_bytes, r->slot(r->head + i),
                static_cast<size_t>(r->slot_bytes));
  }
  r->head = (r->head + got) % r->n_slots;
  r->count -= got;
  lk.unlock();
  if (got > 0) r->can_push.notify_all();
  if (want > got) {
    std::memset(dst + got * r->slot_bytes, 0,
                static_cast<size_t>((want - got) * r->slot_bytes));
  }
  return got;
}

// End-of-stream: producers stop, consumers drain then see -1.
void staging_close(void* h) {
  Ring* r = static_cast<Ring*>(h);
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->closed = true;
  }
  r->can_push.notify_all();
  r->can_pop.notify_all();
}

// Occupancy snapshot (for metrics/backpressure decisions).
int64_t staging_depth(void* h) {
  Ring* r = static_cast<Ring*>(h);
  std::lock_guard<std::mutex> lk(r->mu);
  return r->count;
}

}  // extern "C"
