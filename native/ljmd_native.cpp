// Native runtime components for ljmd_tpu (C ABI, loaded via ctypes).
//
// The reference's "native" layer is its Fortran modules; the pieces that are
// genuinely host-side runtime work — bulk trajectory IO in the Fortran
// unformatted record format (md_simulation_program.f90:248-257,384-387) and
// the ran3-style RNG stream (random_numbers.f90:48-116) — are implemented
// here in C++ for speed, with pure-Python fallbacks in
// ljmd_tpu/io/fortran_records.py and ljmd_tpu/utils/ran3.py.
//
// Build: make -C native   (g++ -O3 -shared -fPIC)
//
// All functions return 0 on success, negative error codes otherwise.

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <unistd.h>  // fsync
#include <vector>

namespace {

constexpr double MBIG = 4.0e6;
constexpr double MSEED = 1618033.0;

struct Ran3State {
  double ma[56];
  int inext, inextp;
};

void ran3_init(Ran3State &s, int64_t seed) {
  double mj = MSEED - (seed < 0 ? -(double)seed : (double)seed);
  if (mj < 0) mj = -mj;
  mj = mj - MBIG * (int64_t)(mj / MBIG);  // fmod on exact small values
  s.ma[55] = mj;
  double mk = 1.0;
  for (int i = 1; i <= 54; ++i) {
    int ii = (21 * i) % 55;
    s.ma[ii] = mk;
    mk = mj - mk;
    if (mk < 0.0) mk += MBIG;
    mj = s.ma[ii];
  }
  for (int k = 0; k < 4; ++k)
    for (int i = 1; i <= 55; ++i) {
      s.ma[i] -= s.ma[1 + (i + 30) % 55];
      if (s.ma[i] < 0.0) s.ma[i] += MBIG;
    }
  s.inext = 0;
  s.inextp = 31;
}

double ran3_next(Ran3State &s) {
  if (++s.inext == 56) s.inext = 1;
  if (++s.inextp == 56) s.inextp = 1;
  double mj = s.ma[s.inext] - s.ma[s.inextp];
  if (mj < 0.0) mj += MBIG;
  s.ma[s.inext] = mj;
  return mj / MBIG;
}

int write_record(FILE *f, const void *payload, int64_t nbytes) {
  int32_t marker = (int32_t)nbytes;
  if (fwrite(&marker, 4, 1, f) != 1) return -2;
  if (nbytes && fwrite(payload, 1, (size_t)nbytes, f) != (size_t)nbytes) return -2;
  if (fwrite(&marker, 4, 1, f) != 1) return -2;
  return 0;
}

// (n_frames, n, 3) row-major -> per-frame component-major (x..., y..., z...)
void frame_to_components(const double *frame, int64_t n, double *scratch) {
  for (int64_t i = 0; i < n; ++i) {
    scratch[i] = frame[3 * i];
    scratch[n + i] = frame[3 * i + 1];
    scratch[2 * n + i] = frame[3 * i + 2];
  }
}

}  // namespace

extern "C" {

// Bulk ran3: fill out[0..n) with the uniform stream for `seed`.
int ljmd_ran3_fill(int64_t seed, double *out, int64_t n) {
  if (!out || n < 0) return -1;
  Ran3State s;
  ran3_init(s, seed);
  for (int64_t i = 0; i < n; ++i) out[i] = ran3_next(s);
  return 0;
}

// Write a complete rva.dat: header + 4 records (r, ru, v, a) per frame.
// Arrays are (n_frames, n, 3) float64 row-major.
int ljmd_write_rva(const char *path, int32_t n, double box_length, double dt,
                   int32_t output_interval, int32_t n_frames, const double *r,
                   const double *ru, const double *v, const double *a) {
  FILE *f = fopen(path, "wb");
  if (!f) return -1;
  struct __attribute__((packed)) Header {
    int32_t n;
    double L, dt;
    int32_t interval, n_snap;
  } h = {n, box_length, dt, output_interval, n_frames};
  int rc = write_record(f, &h, sizeof(h));
  std::vector<double> scratch((size_t)3 * n);
  const double *streams[4] = {r, ru, v, a};
  const int64_t frame_len = (int64_t)3 * n;
  for (int64_t s = 0; rc == 0 && s < n_frames; ++s) {
    for (int k = 0; rc == 0 && k < 4; ++k) {
      frame_to_components(streams[k] + s * frame_len, n, scratch.data());
      rc = write_record(f, scratch.data(), frame_len * 8);
    }
  }
  if (fclose(f) != 0 && rc == 0) rc = -3;
  return rc;
}

// ---------------------------------------------------------------------
// Async streaming writer: a worker thread drains a queue of frame blocks,
// so host-side trajectory IO overlaps device compute (the reference writes
// synchronously inside its MD loop, md_simulation_program.f90:384-387; the
// streaming driver fetches sampled blocks per chunk and must not stall on
// disk).
// ---------------------------------------------------------------------

namespace {

struct AsyncWriter {
  FILE *f = nullptr;
  int32_t n = 0;
  double box_length = 0, dt = 0;
  int32_t interval = 0;
  int64_t frames_written = 0;
  int64_t frames_submitted = 0;
  int error = 0;

  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;
  std::deque<std::vector<double>> queue;  // each: (n_frames*4*3n) doubles
  std::deque<int32_t> queue_frames;
  bool closing = false;

  void run() {
    std::vector<double> scratch((size_t)3 * n);
    for (;;) {
      std::vector<double> block;
      int32_t n_frames = 0;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return !queue.empty() || closing; });
        if (queue.empty()) {
          if (closing) return;
          continue;
        }
        block = std::move(queue.front());
        queue.pop_front();
        n_frames = queue_frames.front();
        queue_frames.pop_front();
      }
      const int64_t frame_len = (int64_t)3 * n;
      for (int32_t s = 0; s < n_frames && error == 0; ++s) {
        for (int k = 0; k < 4 && error == 0; ++k) {
          const double *frame = block.data() + ((size_t)s * 4 + k) * frame_len;
          frame_to_components(frame, n, scratch.data());
          int rc = write_record(f, scratch.data(), frame_len * 8);
          if (rc != 0) error = rc;
        }
      }
      if (error == 0) frames_written += n_frames;
      cv.notify_all();  // wake a close() waiting for drain
    }
  }
};

}  // namespace

extern "C" {

// Open an rva.dat for async appending. append=0: create + write header with
// n_expected; append=1: reopen r+b, seek to end, frames_present already on
// disk. Returns an opaque handle (NULL on failure).
void *ljmd_rva_async_open(const char *path, int32_t n, double box_length,
                          double dt, int32_t output_interval,
                          int32_t n_expected, int32_t append,
                          int64_t frames_present) {
  AsyncWriter *w = new AsyncWriter();
  w->n = n;
  w->box_length = box_length;
  w->dt = dt;
  w->interval = output_interval;
  if (append) {
    w->f = fopen(path, "r+b");
    if (w->f) fseek(w->f, 0, SEEK_END);
    w->frames_written = frames_present;
    w->frames_submitted = frames_present;  // sync() compares the two
  } else {
    w->f = fopen(path, "wb");
    if (w->f) {
      struct __attribute__((packed)) Header {
        int32_t n;
        double L, dt;
        int32_t interval, n_snap;
      } h = {n, box_length, dt, output_interval, n_expected};
      if (write_record(w->f, &h, sizeof(h)) != 0) {
        fclose(w->f);
        w->f = nullptr;
      }
    }
  }
  if (!w->f) {
    delete w;
    return nullptr;
  }
  w->worker = std::thread([w] { w->run(); });
  return w;
}

// Enqueue a block of frames ((n_frames, n, 3) float64 row-major per stream)
// and return immediately; the worker thread formats and writes them.
int ljmd_rva_async_append(void *handle, int32_t n_frames, const double *r,
                          const double *ru, const double *v, const double *a) {
  AsyncWriter *w = (AsyncWriter *)handle;
  if (!w || n_frames < 0) return -1;
  if (w->error) return w->error;
  const int64_t frame_len = (int64_t)3 * w->n;
  std::vector<double> block((size_t)n_frames * 4 * frame_len);
  const double *streams[4] = {r, ru, v, a};
  for (int32_t s = 0; s < n_frames; ++s)
    for (int k = 0; k < 4; ++k)
      std::memcpy(block.data() + ((size_t)s * 4 + k) * frame_len,
                  streams[k] + (size_t)s * frame_len, frame_len * 8);
  {
    std::lock_guard<std::mutex> lk(w->mu);
    w->queue.push_back(std::move(block));
    w->queue_frames.push_back(n_frames);
    w->frames_submitted += n_frames;
  }
  w->cv.notify_all();
  return 0;
}

// Block until every enqueued frame is formatted AND durably on disk
// (fflush + fsync), so a checkpoint written after this call can never claim
// more frames than the file holds — the crash-consistency fence of the
// streaming driver (a kill between checkpoint and drain previously left
// rva.dat with fewer/partial frames than the checkpoint's sample index;
// found by the round-5 N=62500 kill-and-resume demo). Returns the writer's
// error status (0 = ok).
int ljmd_rva_async_sync(void *handle) {
  AsyncWriter *w = (AsyncWriter *)handle;
  if (!w) return -1;
  {
    std::unique_lock<std::mutex> lk(w->mu);
    w->cv.wait(lk, [&] {
      return w->error != 0 ||
             (w->queue.empty() && w->frames_written == w->frames_submitted);
    });
    if (w->error) return w->error;
  }
  if (fflush(w->f) != 0) return -4;
  if (fsync(fileno(w->f)) != 0) return -5;
  return 0;
}

// Drain the queue, patch the header with the actual frame count, close the
// file, and free the handle. Returns the writer's error status (0 = ok).
int ljmd_rva_async_close(void *handle) {
  AsyncWriter *w = (AsyncWriter *)handle;
  if (!w) return -1;
  {
    std::lock_guard<std::mutex> lk(w->mu);
    w->closing = true;
  }
  w->cv.notify_all();
  if (w->worker.joinable()) w->worker.join();
  int rc = w->error;
  if (w->f) {
    struct __attribute__((packed)) Header {
      int32_t n;
      double L, dt;
      int32_t interval, n_snap;
    } h = {w->n, w->box_length, w->dt, w->interval, (int32_t)w->frames_written};
    if (fseek(w->f, 4, SEEK_SET) == 0) fwrite(&h, sizeof(h), 1, w->f);
    if (fclose(w->f) != 0 && rc == 0) rc = -3;
  }
  delete w;
  return rc;
}

// Frames durably formatted so far (after a drain this equals submitted).
int64_t ljmd_rva_async_frames(void *handle) {
  AsyncWriter *w = (AsyncWriter *)handle;
  if (!w) return -1;
  std::lock_guard<std::mutex> lk(w->mu);
  return w->frames_written;
}

}  // extern "C"

// Read an rva.dat header (4-byte markers). Returns 0 on success.
int ljmd_read_rva_header(const char *path, int32_t *n, double *box_length,
                         double *dt, int32_t *output_interval,
                         int32_t *n_frames_header, int64_t *n_frames_actual) {
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  int32_t m0, m1;
  struct __attribute__((packed)) Header {
    int32_t n;
    double L, dt;
    int32_t interval, n_snap;
  } h;
  if (fread(&m0, 4, 1, f) != 1 || m0 != (int32_t)sizeof(h)) { fclose(f); return -2; }
  if (fread(&h, sizeof(h), 1, f) != 1) { fclose(f); return -2; }
  if (fread(&m1, 4, 1, f) != 1 || m1 != m0) { fclose(f); return -2; }
  *n = h.n; *box_length = h.L; *dt = h.dt;
  *output_interval = h.interval; *n_frames_header = h.n_snap;
  // count body records
  int64_t records = 0;
  for (;;) {
    int32_t mark;
    if (fread(&mark, 4, 1, f) != 1) break;
    if (fseek(f, mark + 4, SEEK_CUR) != 0) break;
    ++records;
  }
  *n_frames_actual = records / 4;
  fclose(f);
  return 0;
}

// Read all frames of an rva.dat into caller-allocated (n_frames, n, 3)
// buffers (row-major), converting from component-major records.
int ljmd_read_rva_frames(const char *path, int32_t n, int64_t n_frames,
                         double *r, double *ru, double *v, double *a) {
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  // skip header record
  int32_t mark;
  if (fread(&mark, 4, 1, f) != 1 || fseek(f, mark + 4, SEEK_CUR) != 0) {
    fclose(f);
    return -2;
  }
  std::vector<double> scratch((size_t)3 * n);
  double *streams[4] = {r, ru, v, a};
  const int64_t frame_len = (int64_t)3 * n;
  for (int64_t s = 0; s < n_frames; ++s) {
    for (int k = 0; k < 4; ++k) {
      int32_t m0, m1;
      if (fread(&m0, 4, 1, f) != 1 || m0 != frame_len * 8) { fclose(f); return -3; }
      if (fread(scratch.data(), 8, (size_t)frame_len, f) != (size_t)frame_len) {
        fclose(f);
        return -3;
      }
      if (fread(&m1, 4, 1, f) != 1 || m1 != m0) { fclose(f); return -3; }
      double *dst = streams[k] + s * frame_len;
      for (int64_t i = 0; i < n; ++i) {
        dst[3 * i] = scratch[i];
        dst[3 * i + 1] = scratch[n + i];
        dst[3 * i + 2] = scratch[2 * n + i];
      }
    }
  }
  fclose(f);
  return 0;
}

}  // extern "C"
