/*
 * auron_tpu_torch host-engine bridge: C ABI specification.
 *
 * A copy of native/auron_bridge.h (the JAX package's bridge), the same ABI:
 * the boundary a JVM (or any out-of-process) front end binds against,
 * mirroring the reference's 4 JNI entry points + resource registry
 * (auron-core JniBridge.java:49-80). auron_tpu_torch/bridge/api.py
 * implements it; auron_bridge.cpp embeds CPython to reach it.
 *
 * Tasks run on the CUDA device. A host that wants the CPU sets
 * AURON_TORCH_DEVICE=cpu in its environment before the first call; a CUDA
 * task without a card fails (auron_last_error says why), it never falls
 * back.
 *
 * Memory: all buffers returned by the engine are owned by the engine and
 * valid until the next call on the same handle; callers copy out. Batches
 * cross the boundary as Arrow IPC stream bytes (the C-data-interface
 * equivalent for out-of-process hosts).
 */

#ifndef AURON_BRIDGE_H
#define AURON_BRIDGE_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef int64_t auron_task_handle;

/* Start the engine now (the embedded interpreter, its imports and the
 * device) instead of at the first call below, which does the same.
 * Returns 0, or -1 (auron_last_error has details). */
int auron_init(void);

/* Start a task from a serialized TaskDefinition protobuf.
 * Returns a positive handle, or a negative error code. */
auron_task_handle auron_call_native(const uint8_t* task_def, size_t len);

/* Pull the next output batch as an Arrow IPC stream.
 * Returns 1 and sets (*data, *len) when a batch is available,
 * 0 at end-of-stream, negative on error (auron_last_error has details). */
int auron_next_batch(auron_task_handle h, const uint8_t** data, size_t* len);

/* Cancel/drain/join the task; returns the metric tree as JSON. */
int auron_finalize_native(auron_task_handle h, const uint8_t** metrics_json,
                          size_t* len);

/* Shut down every live task (host engine exit hook). */
void auron_on_exit(void);

/* Resource map: hand scan providers / shuffle block channels / UDF
 * contexts to tasks. auron_put_resource ships batch data as an Arrow IPC
 * stream (decoded into a batch list for scan/ffi readers — payloads MUST
 * be valid IPC); auron_put_resource_bytes ships opaque raw bytes (file
 * paths, conf blobs) with no interpretation. */
int auron_put_resource(const char* key, const uint8_t* value, size_t len);
int auron_put_resource_bytes(const char* key, const uint8_t* value,
                             size_t len);

/* Arrow C data interface (zero-serde boundary, the in-process twin of the
 * IPC entries above — the reference's L4 design: batches cross as
 * pointers, never bytes).
 *
 * auron_put_resource_arrow: `stream` is a `struct ArrowArrayStream*`
 * (arrow/c/abi.h; declared void* here so embedders without Arrow headers
 * can still bind the rest of the ABI). The engine takes ownership per the
 * C-stream spec (it will call the release callback); the host must keep
 * the struct memory alive until the call returns. Batches are imported
 * lazily as the consuming task pulls them.
 *
 * auron_next_batch_arrow: exports the task's next batch into
 * host-allocated `struct ArrowArray*` / `struct ArrowSchema*` structs;
 * ownership of the exported buffers transfers to the host via the structs'
 * release callbacks. Returns 1 on a batch, 0 at end-of-stream, negative
 * on error. */
int auron_put_resource_arrow(const char* key, void* stream);
int auron_next_batch_arrow(auron_task_handle h, void* out_array,
                           void* out_schema);
/* Shuffle fetch registration: the payload is a JSON manifest of committed
 * map outputs ([{"data": path, "index": path}, ...]) — the MapStatus/
 * shuffle-fetch contract for host-scheduled stages. The reduce task's
 * ipc_reader with this key then reads exactly those blocks. */
int auron_put_resource_shuffle(const char* key, const uint8_t* manifest,
                               size_t len);
int auron_remove_resource(const char* key);

/* Conversion service: host-plan JSON in, segmentation-response JSON out
 * (the engine-side AuronConverters; see auron_tpu/convert/service.py for
 * the response schema). The response buffer is engine-owned, per-thread,
 * and valid until the CALLING thread's next auron_convert_plan call.
 * Returns 0 on success, negative on error. Not ported to auron_tpu_torch
 * yet: it fails and auron_last_error names the ROADMAP item. */
int auron_convert_plan(const uint8_t* host_plan_json, size_t len,
                       const uint8_t** response_json, size_t* response_len);

/* Host UDF evaluation callback (the reference's JVM-callback UDF wrapper
 * channel, SparkUDFWrapperContext/HiveUDFUtil): the host registers ONE
 * process-wide evaluator; the engine calls it for every host-wrapped
 * expression (e.g. Hive UDFs). udf_blob is the host-serialized function
 * (the serializer embedded it in the plan, so tasks evaluate it on ANY
 * executor — no driver-local registry); args_ipc is an Arrow IPC stream
 * with the argument columns (a0..aN, batch-length rows, padding rows
 * included — the engine keeps the selection mask); the callback returns
 * 0 and an IPC stream with ONE result column, or nonzero on failure.
 * The result buffer is HOST-owned and must stay valid until the next
 * call from the same engine thread. */
typedef int (*auron_udf_eval_fn)(const uint8_t* udf_blob, size_t blob_len,
                                 const uint8_t* args_ipc, size_t args_len,
                                 const uint8_t** out_ipc, size_t* out_len);
/* Not ported to auron_tpu_torch yet: fails, auron_last_error says why. */
int auron_register_udf_callback(auron_udf_eval_fn fn);

/* Last error message for the calling thread (UTF-8, engine-owned). */
const char* auron_last_error(void);

#ifdef __cplusplus
}
#endif

#endif /* AURON_BRIDGE_H */
