//  speedy_tpu native runtime — C ABI compatible with the reference's
//  sonic2 shim (sonic2.h:54-125) and speedy analysis surface
//  (speedy.h:61-133). Fresh implementation for the JAX framework:
//  the algorithms follow the same published Mach1 spec as the JAX ops in
//  ../speedy_tpu/ops (which are the source of truth for parity tests).
//
//  This library is the host-side streaming runtime: C/C++ applications
//  (or the Python ctypes binding in speedy_tpu/native.py) drive it for
//  latency-shaped use; corpus-scale throughput belongs to the batched
//  JAX path on the GPU.

#ifndef SPEEDY_TPU_NATIVE_H_
#define SPEEDY_TPU_NATIVE_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ------------------------------------------------------------------ */
/* Speedy analysis stream (speedy.h surface)                           */
/* ------------------------------------------------------------------ */
struct speedyStreamStruct;
typedef struct speedyStreamStruct* speedyStream;

speedyStream speedyCreateStream(int sample_rate);
void speedyDestroyStream(speedyStream stream);
int speedyInputFrameSize(speedyStream stream);  /* analysis window, samples */
int speedyInputFrameStep(speedyStream stream);  /* frame step, samples */
int speedyFFTSize(speedyStream stream);
float speedyBinToFreq(speedyStream stream, int bin_number);
int speedyFreqToBin(speedyStream stream, float freq);
void speedyAddData(speedyStream stream, const float* input, int64_t at_time);
void speedyAddDataShort(speedyStream stream, const int16_t* input,
                        int64_t at_time);
int speedyComputeTension(speedyStream stream, int64_t at_time, float* tension);
float speedyComputeSpeedFromTension(float tension, float R_g,
                                    float duration_feedback_strength,
                                    speedyStream stream);
int64_t speedyGetCurrentTime(speedyStream stream);
float* speedyGetInternalState(speedyStream stream);    /* 15 floats */
float* speedyGetSpectrogram(speedyStream stream);      /* fft_size floats */
float* speedyGetNormalizedSpectrogram(speedyStream stream);

/* White-box test surface (speedy.h:89-133 parity). */
float* speedySpectrogram(speedyStream stream, float* input);
float speedyEvaluateHysteresis(speedyStream stream, int64_t at_time);
void speedyAddToHysteresisBuffer(speedyStream stream, float value,
                                 int64_t at_time);
float* speedyGetSpectrogramAtTime(speedyStream stream, int64_t at_time);
void speedyPreemphasisFilter(speedyStream stream, float* input, int length);
float speedyNormalizeByEnergy(const float* spectrogram, float* normalized,
                              int length);

/* FirstOrderFilter C API (speedy.h:124-133). */
struct FirstOrderFilterStruct;
typedef struct FirstOrderFilterStruct* FirstOrderFilter;
FirstOrderFilter CreateFirstOrderFilter(float time_constant_in_samples);
void DesignFirstOrderLowpassFilter(FirstOrderFilter fof,
                                   float time_constant_in_samples);
float IterateFirstOrderFilter(FirstOrderFilter fof, float input);
void ResetFirstOrderFilter(FirstOrderFilter fof);
void SetFirstOrderFilterState(FirstOrderFilter fof, float new_state);
void DeleteFirstOrderFilter(FirstOrderFilter fof);

#define kFeatureValueCount 15

/* ------------------------------------------------------------------ */
/* sonic2-compatible streaming shim                                    */
/* ------------------------------------------------------------------ */
struct sonicStreamStruct;
typedef struct sonicStreamStruct* sonicStream;

sonicStream sonicCreateStream(int sampleRate, int numChannels);
void sonicDestroyStream(sonicStream stream);
/* One "sample" spans all channels (sonic2.h:56-59). Returns 1 on success. */
int sonicWriteShortToStream(sonicStream stream, const int16_t* inBuffer,
                            int sampleCount);
int sonicReadShortFromStream(sonicStream stream, int16_t* outBuffer,
                             int bufferSize);
int sonicWriteFloatToStream(sonicStream stream, const float* inBuffer,
                            int sampleCount);
int sonicReadFloatFromStream(sonicStream stream, float* outBuffer,
                             int bufferSize);
int sonicFlushStream(sonicStream stream);
int sonicSamplesAvailable(sonicStream stream);
void sonicSetSpeed(sonicStream stream, float speed);
void sonicSetRate(sonicStream stream, float rate);
void sonicEnableNonlinearSpeedup(sonicStream stream, float nonlinearFactor);
void sonicSetDurationFeedbackStrength(sonicStream stream, float factor);
int getSonicBufferSize(sonicStream stream);
int sonicSpectrogramSize(sonicStream stream);
int sonicGetNumChannels(sonicStream stream);

/* Monitoring callbacks (sonic2.h:104-124). */
typedef void (*tensionFunction)(sonicStream stream, int time, float tension);
typedef void (*speedFunction)(sonicStream stream, int time, float speed);
typedef void (*featuresFunction)(sonicStream stream, int time,
                                 float* features);
typedef void (*spectrogramFunction)(sonicStream stream, int time,
                                    float* spectrogram);
void sonicTensionCallback(sonicStream stream, tensionFunction fn);
void sonicSpeedCallback(sonicStream stream, speedFunction fn);
void sonicFeaturesCallback(sonicStream stream, featuresFunction fn);
void sonicSpectrogramCallback(sonicStream stream, spectrogramFunction fn);
void sonicNormalizedSpectrogramCallback(sonicStream stream,
                                        spectrogramFunction fn);
/* Callback getters (sonic2.h:106-124). getSonicSpeedCallback returns
 * tensionFunction — not speedFunction — matching the reference header's
 * declaration verbatim for drop-in source parity (the two function types
 * share a signature, so the value is the registered speed callback). */
tensionFunction getSonicTensionCallback(sonicStream stream);
tensionFunction getSonicSpeedCallback(sonicStream stream);
featuresFunction getSonicFeaturesCallback(sonicStream stream);
spectrogramFunction getSonicSpectrogramCallback(sonicStream stream);
spectrogramFunction getSonicNormalizedSpectrogramCallback(sonicStream stream);

/* ------------------------------------------------------------------ */
/* WAV I/O (replacement for the external wave.h, component C20)        */
/* ------------------------------------------------------------------ */
struct waveFileStruct;
typedef struct waveFileStruct* waveFile;

waveFile openInputWaveFile(const char* fileName, int* sampleRate,
                           int* numChannels);
waveFile openOutputWaveFile(const char* fileName, int sampleRate,
                            int numChannels);
/* Returns multi-channel sample count read (maxSamples is per channel). */
int readFromWaveFile(waveFile file, int16_t* buffer, int maxSamples);
int writeToWaveFile(waveFile file, const int16_t* buffer, int numSamples);
void closeWaveFile(waveFile file);

#ifdef __cplusplus
}
#endif

#endif  /* SPEEDY_TPU_NATIVE_H_ */
