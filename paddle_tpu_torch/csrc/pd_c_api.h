// The port's C inference API (reference paddle/fluid/inference/capi/
// paddle_c_api.h; the JAX package's csrc/pd_c_api.h, whose five symbols
// and semantics it keeps). Implemented by inference_capi.cc, which embeds
// CPython and drives paddle_tpu_torch.inference; built by g++ at first use
// (paddle_tpu_torch.inference.capi.build()) into
// build/paddle_tpu_torch/capi-<hash>/libpd_infer_capi.so. Consumed by any
// C caller, the Go binding (go/paddle/, cgo) and the R shim.
//
// Single-threaded contract: call the API from one thread at a time.
#ifndef PADDLE_TPU_TORCH_PD_C_API_H_
#define PADDLE_TPU_TORCH_PD_C_API_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct PD_Predictor PD_Predictor;

// Last error message from any failed call (never NULL), e.g.
// "UnavailableError: device cuda:0 requested but ...".
const char* PD_GetLastError();

// Create a predictor from a saved model prefix ({prefix}.pdmodel /
// {prefix}.pdiparams / {prefix}.pdmeta, as written by jit.save) on CUDA
// card 0, the default of inference.Config. Where there is no card it
// fails (NULL, the reason in PD_GetLastError): it never falls back to the
// CPU. NULL on failure.
PD_Predictor* PD_NewPredictor(const char* model_prefix);

// As PD_NewPredictor, on the device the caller names: a negative
// device_id is the CPU (Config.disable_gpu()), any other id is that CUDA
// card (Config.enable_use_gpu(device_id=...)); an id that names no card
// fails with the reason in PD_GetLastError. NULL on failure.
PD_Predictor* PD_NewPredictorWithDevice(const char* model_prefix,
                                        int device_id);

// Run with one float32 input tensor. The first output is copied to the
// host before the call returns: *out_data is malloc'd (free with
// PD_FreeBuffer); out_shape must hold 8 dims (an output of higher rank
// fails). Returns 0 on success.
int PD_PredictorRun(PD_Predictor* pred, const float* input,
                    const int64_t* shape, int ndim, float** out_data,
                    int64_t* out_shape, int* out_ndim);

void PD_FreeBuffer(void* p);

void PD_DeletePredictor(PD_Predictor* pred);

#ifdef __cplusplus
}  // extern "C"
#endif

#endif  // PADDLE_TPU_TORCH_PD_C_API_H_
