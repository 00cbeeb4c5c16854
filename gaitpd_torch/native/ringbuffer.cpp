// Streaming sliding-window ring buffer for real-time sensor ingestion.
//
// Native runtime component of the serving path (gaitpd_torch.serve): sensors
// push frames as they arrive; the buffer emits strict full windows with the
// same (win, hop) semantics as the offline pipeline
// (gaitpd_torch/data/pipeline.py::window_indices, itself matching the
// reference's dataloader_weargait.py:230-237). Windows are materialised
// contiguously so they can be handed to the device feed without further host
// copies. The port's own copy of gaitpd/native/ringbuffer.cpp.
//
// C ABI only (consumed via ctypes).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct RingBuffer {
  int64_t channels;
  int64_t win;
  int64_t hop;
  int64_t capacity;      // frames the ring can hold
  std::vector<float> data;  // capacity * channels
  int64_t head = 0;      // absolute index of the oldest retained frame
  int64_t total = 0;     // absolute count of frames ever pushed
  int64_t next_start = 0;  // absolute start index of the next window
  int64_t dropped = 0;   // frames evicted before being windowed

  RingBuffer(int64_t ch, int64_t w, int64_t h, int64_t cap)
      : channels(ch), win(w), hop(h), capacity(cap), data(cap * ch, 0.0f) {}

  float* frame(int64_t abs_idx) {
    return data.data() + (abs_idx % capacity) * channels;
  }
};

}  // namespace

extern "C" {

// Create a buffer holding `capacity` frames of `channels` floats, emitting
// (win, hop) windows. capacity must be >= win (enforced).
void* rb_create(int64_t channels, int64_t win, int64_t hop, int64_t capacity) {
  if (channels <= 0 || win <= 0 || hop <= 0) return nullptr;
  if (capacity < win) capacity = win * 2;
  return new RingBuffer(channels, win, hop, capacity);
}

void rb_destroy(void* rb) { delete static_cast<RingBuffer*>(rb); }

// Push n frames of (n, channels) float32 data. Returns frames accepted
// (always n; old frames are evicted when the ring is full — if an unread
// window falls off the back, `rb_dropped` counts its frames).
int64_t rb_push(void* rbp, const float* frames, int64_t n) {
  auto* rb = static_cast<RingBuffer*>(rbp);
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(rb->frame(rb->total), frames + i * rb->channels,
                rb->channels * sizeof(float));
    rb->total += 1;
    if (rb->total - rb->head > rb->capacity) {
      rb->head = rb->total - rb->capacity;
      if (rb->next_start < rb->head) {
        rb->dropped += rb->head - rb->next_start;
        // re-align to the hop grid at or after the new head
        int64_t behind = rb->head - rb->next_start;
        int64_t steps = (behind + rb->hop - 1) / rb->hop;
        rb->next_start += steps * rb->hop;
      }
    }
  }
  return n;
}

// Number of complete windows currently available.
int64_t rb_ready(void* rbp) {
  auto* rb = static_cast<RingBuffer*>(rbp);
  if (rb->total - rb->next_start < rb->win) return 0;
  return (rb->total - rb->win - rb->next_start) / rb->hop + 1;
}

// Pop up to max_windows windows into out (max_windows * win * channels
// floats, window-major). Returns windows written.
int64_t rb_pop(void* rbp, float* out, int64_t max_windows) {
  auto* rb = static_cast<RingBuffer*>(rbp);
  int64_t written = 0;
  while (written < max_windows && rb->total - rb->next_start >= rb->win) {
    for (int64_t t = 0; t < rb->win; ++t) {
      std::memcpy(out + (written * rb->win + t) * rb->channels,
                  rb->frame(rb->next_start + t),
                  rb->channels * sizeof(float));
    }
    rb->next_start += rb->hop;
    written += 1;
  }
  return written;
}

int64_t rb_dropped(void* rbp) {
  return static_cast<RingBuffer*>(rbp)->dropped;
}

int64_t rb_total(void* rbp) { return static_cast<RingBuffer*>(rbp)->total; }

}  // extern "C"
