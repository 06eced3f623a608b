// DIO-style F0 estimator (native tier of the port): the port's own copy of
// fastspeech2_tpu/native/dio.cc, unchanged but for these comments.
//
// The reference delegates F0 extraction to PyWORLD's DIO
// (its dataset/audio_processing.py:54-70).  This is an
// independent C++ implementation of the same interval-based algorithm family
// (Morise et al., "DIO: a fast and reliable F0 estimator", 2009):
//
//   1. zero-phase low-pass the waveform at a bank of half-octave cutoffs
//      spanning [f0_floor, f0_ceil]; near the cutoff matching the true F0 the
//      filtered signal is close to a pure sine at the fundamental;
//   2. on each filtered band, measure the four fundamental-period event
//      intervals (positive/negative zero crossings, peaks, dips);
//   3. per analysis frame, each band proposes F0 = mean of the four interval
//      estimates with reliability = their relative spread;
//   4. pick the most reliable in-range candidate; frames whose best spread
//      exceeds a threshold are unvoiced (F0 = 0);
//   5. a short median pass removes isolated octave spikes.
//
// Exposed via a C ABI for ctypes (fastspeech2_tpu_torch/native/__init__.py).
// Written from the algorithm description; no WORLD source was used.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Zero-phase 2nd-order Butterworth low-pass (forward + reverse => 4th order,
// no phase distortion -- event times stay aligned with the input).
// ---------------------------------------------------------------------------

struct Biquad {
  double b0, b1, b2, a1, a2;
};

Biquad butter_lowpass(double cutoff_hz, double fs) {
  const double w = std::tan(M_PI * cutoff_hz / fs);
  const double k = std::sqrt(2.0);
  const double norm = 1.0 / (1.0 + k * w + w * w);
  Biquad q;
  q.b0 = w * w * norm;
  q.b1 = 2.0 * q.b0;
  q.b2 = q.b0;
  q.a1 = 2.0 * (w * w - 1.0) * norm;
  q.a2 = (1.0 - k * w + w * w) * norm;
  return q;
}

void biquad_forward(const Biquad& q, std::vector<double>* x) {
  double x1 = 0, x2 = 0, y1 = 0, y2 = 0;
  for (double& v : *x) {
    const double x0 = v;
    const double y0 = q.b0 * x0 + q.b1 * x1 + q.b2 * x2 - q.a1 * y1 - q.a2 * y2;
    x2 = x1; x1 = x0; y2 = y1; y1 = y0;
    v = y0;
  }
}

void zero_phase_lowpass(double cutoff_hz, double fs, std::vector<double>* x) {
  const Biquad q = butter_lowpass(cutoff_hz, fs);
  biquad_forward(q, x);
  std::reverse(x->begin(), x->end());
  biquad_forward(q, x);
  std::reverse(x->begin(), x->end());
}

// ---------------------------------------------------------------------------
// Interval events on a (nearly sinusoidal) band signal.
// Each event stream yields samples (t_mid, f0 = 1/interval); linear
// interpolation evaluates the stream at arbitrary frame times.
// ---------------------------------------------------------------------------

struct EventTrack {
  std::vector<double> t;   // interval midpoint, seconds
  std::vector<double> f;   // 1 / interval, Hz

  // piecewise-linear evaluation; 0 outside the covered span or across a gap
  // longer than ~2 periods (events stop during silence -- interpolating over
  // the gap would invent F0 where there is none)
  double eval(double at) const {
    if (t.size() < 2 || at < t.front() || at > t.back()) return 0.0;
    auto it = std::lower_bound(t.begin(), t.end(), at);
    size_t hi = static_cast<size_t>(it - t.begin());
    if (hi == 0) return f.front();
    const size_t lo = hi - 1;
    const double den = t[hi] - t[lo];
    if (den <= 0) return f[lo];
    if (den > 2.0 / std::min(f[lo], f[hi])) return 0.0;
    const double w = (at - t[lo]) / den;
    return f[lo] * (1.0 - w) + f[hi] * w;
  }
};

void intervals_to_track(const std::vector<double>& times, EventTrack* tr) {
  for (size_t i = 0; i + 1 < times.size(); ++i) {
    const double dt = times[i + 1] - times[i];
    if (dt <= 0) continue;
    tr->t.push_back(0.5 * (times[i] + times[i + 1]));
    tr->f.push_back(1.0 / dt);
  }
}

// zero-crossing times with sub-sample linear interpolation
void zero_crossings(const std::vector<double>& x, double fs, bool positive_going,
                    EventTrack* tr) {
  std::vector<double> times;
  for (size_t i = 0; i + 1 < x.size(); ++i) {
    const bool cross = positive_going ? (x[i] <= 0.0 && x[i + 1] > 0.0)
                                      : (x[i] >= 0.0 && x[i + 1] < 0.0);
    if (!cross) continue;
    const double den = x[i + 1] - x[i];
    const double frac = (den != 0.0) ? -x[i] / den : 0.0;
    times.push_back((static_cast<double>(i) + frac) / fs);
  }
  intervals_to_track(times, tr);
}

// local extrema times (peaks when sign=+1, dips when sign=-1) with parabolic
// sub-sample interpolation
void extrema(const std::vector<double>& x, double fs, int sign, EventTrack* tr) {
  std::vector<double> times;
  for (size_t i = 1; i + 1 < x.size(); ++i) {
    const double a = sign * x[i - 1], b = sign * x[i], c = sign * x[i + 1];
    if (b > a && b >= c && b > 0.0) {
      const double den = a - 2.0 * b + c;
      double frac = 0.0;
      if (den < 0.0) frac = 0.5 * (a - c) / den;
      times.push_back((static_cast<double>(i) + frac) / fs);
    }
  }
  intervals_to_track(times, tr);
}

}  // namespace

extern "C" {

// wav: float32 [-1,1]; writes n/hop+1 frames of F0 (Hz, 0 = unvoiced) into
// f0_out (capacity max_frames). Returns the frame count, or -1 on bad args.
int fs2_dio(const float* wav, int64_t n, int sample_rate, int hop_length,
            double f0_floor, double f0_ceil, float* f0_out,
            int64_t max_frames) {
  if (n <= 0 || sample_rate <= 0 || hop_length <= 0 || f0_floor <= 0 ||
      f0_ceil <= f0_floor)
    return -1;
  const int64_t n_frames = n / hop_length + 1;
  if (n_frames > max_frames) return -1;
  const double fs = sample_rate;

  // half-octave filterbank spanning [f0_floor, f0_ceil]
  const double channels_in_octave = 2.0;
  const int n_bands =
      static_cast<int>(std::ceil(std::log2(f0_ceil / f0_floor) *
                                 channels_in_octave)) + 1;

  std::vector<double> frame_t(n_frames);
  for (int64_t i = 0; i < n_frames; ++i)
    frame_t[i] = static_cast<double>(i * hop_length) / fs;

  // per-frame candidate list: (f0, spread) for every band that produced a
  // consistent estimate
  std::vector<std::vector<std::pair<double, double>>> cands(n_frames);

  const std::vector<double> base(wav, wav + n);
  for (int band = 0; band < n_bands; ++band) {
    const double fc = f0_floor * std::pow(2.0, (band + 1) / channels_in_octave);
    std::vector<double> x(base.begin(), base.end());
    zero_phase_lowpass(std::min(fc, 0.45 * fs), fs, &x);

    EventTrack tracks[4];
    zero_crossings(x, fs, /*positive_going=*/true, &tracks[0]);
    zero_crossings(x, fs, /*positive_going=*/false, &tracks[1]);
    extrema(x, fs, +1, &tracks[2]);
    extrema(x, fs, -1, &tracks[3]);

    for (int64_t i = 0; i < n_frames; ++i) {
      double est[4];
      double mean = 0.0;
      bool ok = true;
      for (int k = 0; k < 4; ++k) {
        est[k] = tracks[k].eval(frame_t[i]);
        if (est[k] <= 0.0) { ok = false; break; }
        mean += est[k];
      }
      if (!ok) continue;
      mean *= 0.25;
      // a band's low-pass keeps any fundamental below ~2x its cutoff intact
      // enough for clean intervals (amplitude attenuation does not disturb
      // interval measurements); candidates far above that are harmonic
      // mixtures and stay out
      if (mean < f0_floor || mean > f0_ceil || mean > fc * 2.0) continue;
      double var = 0.0;
      for (int k = 0; k < 4; ++k) var += (est[k] - mean) * (est[k] - mean);
      const double spread = std::sqrt(var * 0.25) / mean;  // relative stddev
      if (spread < 0.12) cands[i].emplace_back(mean, spread);
    }
  }

  // silence gate: the interval measures are amplitude-blind, so filter
  // ringing after a sound/silence edge would stay "periodic" -- gate frames
  // whose raw RMS sits 60 dB below the utterance peak
  double peak = 0.0;
  for (int64_t i = 0; i < n; ++i) peak = std::max(peak, std::fabs(base[i]));
  const double gate = 1e-3 * peak;
  std::vector<bool> audible(n_frames, false);
  for (int64_t i = 0; i < n_frames; ++i) {
    const int64_t c = i * hop_length;
    const int64_t lo = std::max<int64_t>(0, c - hop_length);
    const int64_t hi = std::min(n, c + hop_length);
    double acc = 0.0;
    for (int64_t j = lo; j < hi; ++j) acc += base[j] * base[j];
    audible[i] = hi > lo && std::sqrt(acc / (hi - lo)) > gate;
  }

  // voicing + selection: a genuine fundamental survives in at least two
  // adjacent bands with the SAME frequency, while narrow-band-filtered noise
  // oscillates near each band's own cutoff -- so require a second band to
  // corroborate the winner within 5%
  std::vector<double> f0(n_frames, 0.0);
  for (int64_t i = 0; i < n_frames; ++i) {
    if (!audible[i]) continue;
    // corroborated candidates only (see above), then take the LOWEST
    // quality-comparable one: formant-amplified harmonics (2xF0, 3xF0) also
    // form clean corroborated candidates in speech, but the fundamental is
    // the lowest strong periodicity present
    double best_spread = 1e30;
    std::vector<std::pair<double, double>> ok;
    for (size_t a = 0; a < cands[i].size(); ++a) {
      bool corroborated = false;
      for (size_t b = 0; b < cands[i].size(); ++b) {
        if (a == b) continue;
        if (std::fabs(cands[i][a].first - cands[i][b].first) <
            0.05 * cands[i][a].first) {
          corroborated = true;
          break;
        }
      }
      if (!corroborated) continue;
      ok.push_back(cands[i][a]);
      best_spread = std::min(best_spread, cands[i][a].second);
    }
    double best = 0.0;
    for (const auto& c : ok)
      if (c.second < 3.0 * best_spread + 0.02 &&
          (best == 0.0 || c.first < best))
        best = c.first;
    f0[i] = best;
  }

  // remove isolated octave spikes / dropouts with a 5-point median over
  // voiced neighbourhoods
  for (int64_t i = 0; i < n_frames; ++i) {
    double window[5];
    int m = 0;
    for (int64_t j = std::max<int64_t>(0, i - 2);
         j <= std::min<int64_t>(n_frames - 1, i + 2); ++j)
      window[m++] = f0[j];
    std::sort(window, window + m);
    f0_out[i] = static_cast<float>(window[m / 2]);
  }
  return static_cast<int>(n_frames);
}

const char* fs2_native_version() { return "fs2native-1"; }

}  // extern "C"
