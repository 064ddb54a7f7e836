/*
 * C test harness for the auron_tpu_torch bridge ABI: a stand-in host engine
 * (a copy of native/bridge_harness.c, the JAX package's harness).
 *
 * Drives a TaskDefinition end-to-end through libauron_bridge exactly like
 * a JVM shim would: register resources, start the task, pump batches,
 * finalize, exit. Usage:
 *
 *   bridge_harness <taskdef.bin> <out.bin> [<key> <resource.bin>]...
 *   bridge_harness --convert <hostplan.json> <response.json>
 *
 * Resource keys are registered as Arrow IPC batch payloads; a key of the
 * form "shuffle:<id>" registers its file as a shuffle-fetch JSON manifest
 * under <id> instead (host-scheduled reduce stage input). out.bin:
 * sequence of [u64 little-endian length][arrow IPC stream bytes] per
 * pulled batch. The finalize metrics JSON goes to stdout; stderr gets one
 * line "harness_timing {...}" with the seconds of the engine's start
 * (auron_init: the interpreter, its imports, the device), the resource
 * registrations and the task (call_native to finalize). Tasks run on the
 * CUDA device unless AURON_TORCH_DEVICE=cpu is set.
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "auron_bridge.h"

static double now_s(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}

static uint8_t* read_file(const char* path, size_t* out_len) {
  FILE* f = fopen(path, "rb");
  if (f == NULL) {
    fprintf(stderr, "cannot open %s\n", path);
    exit(2);
  }
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  uint8_t* buf = (uint8_t*)malloc((size_t)n);
  if (fread(buf, 1, (size_t)n, f) != (size_t)n) {
    fprintf(stderr, "short read on %s\n", path);
    exit(2);
  }
  fclose(f);
  *out_len = (size_t)n;
  return buf;
}

int main(int argc, char** argv) {
  if (argc == 4 && strcmp(argv[1], "--convert") == 0) {
    /* conversion-service mode: host-plan JSON -> segmentation JSON */
    size_t len = 0;
    uint8_t* payload = read_file(argv[2], &len);
    const uint8_t* resp = NULL;
    size_t resp_len = 0;
    if (auron_convert_plan(payload, len, &resp, &resp_len) != 0) {
      fprintf(stderr, "convert_plan failed: %s\n", auron_last_error());
      return 7;
    }
    free(payload);
    FILE* cf = fopen(argv[3], "wb");
    if (cf == NULL) {
      fprintf(stderr, "cannot open %s\n", argv[3]);
      return 2;
    }
    fwrite(resp, 1, resp_len, cf);
    fclose(cf);
    auron_on_exit();
    return 0;
  }
  if (argc < 3 || (argc - 3) % 2 != 0) {
    fprintf(stderr,
            "usage: %s <taskdef.bin> <out.bin> [<key> <file>]...\n"
            "       %s --convert <hostplan.json> <response.json>\n",
            argv[0], argv[0]);
    return 2;
  }

  double t0 = now_s();
  if (auron_init() != 0) {
    fprintf(stderr, "init failed: %s\n", auron_last_error());
    return 8;
  }
  double t_init = now_s();
  for (int i = 3; i + 1 < argc; i += 2) {
    size_t len = 0;
    uint8_t* payload = read_file(argv[i + 1], &len);
    int rc;
    if (strncmp(argv[i], "shuffle:", 8) == 0) {
      rc = auron_put_resource_shuffle(argv[i] + 8, payload, len);
    } else {
      rc = auron_put_resource(argv[i], payload, len);
    }
    if (rc != 0) {
      fprintf(stderr, "put_resource(%s) failed: %s\n", argv[i],
              auron_last_error());
      return 3;
    }
    free(payload);
  }

  double t_resources = now_s();
  size_t task_len = 0;
  uint8_t* task = read_file(argv[1], &task_len);
  auron_task_handle h = auron_call_native(task, task_len);
  free(task);
  if (h < 0) {
    fprintf(stderr, "call_native failed: %s\n", auron_last_error());
    return 4;
  }

  FILE* out = fopen(argv[2], "wb");
  if (out == NULL) {
    fprintf(stderr, "cannot open %s\n", argv[2]);
    return 2;
  }
  for (;;) {
    const uint8_t* data = NULL;
    size_t len = 0;
    int rc = auron_next_batch(h, &data, &len);
    if (rc == 0) break;
    if (rc < 0) {
      fprintf(stderr, "next_batch failed: %s\n", auron_last_error());
      return 5;
    }
    uint64_t n = (uint64_t)len;
    fwrite(&n, sizeof(n), 1, out);
    fwrite(data, 1, len, out);
  }
  fclose(out);

  const uint8_t* metrics = NULL;
  size_t mlen = 0;
  if (auron_finalize_native(h, &metrics, &mlen) != 0) {
    fprintf(stderr, "finalize failed: %s\n", auron_last_error());
    return 6;
  }
  fwrite(metrics, 1, mlen, stdout);
  fputc('\n', stdout);
  fprintf(stderr,
          "harness_timing {\"init_s\": %.6f, \"resources_s\": %.6f, "
          "\"task_s\": %.6f}\n",
          t_init - t0, t_resources - t_init, now_s() - t_resources);

  auron_on_exit();
  return 0;
}
