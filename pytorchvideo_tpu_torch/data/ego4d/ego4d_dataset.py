"""The Ego4d moments dataset: video, and optionally audio as a
spectrogram and IMU windows (counterpart of
pytorchvideo_tpu/data/ego4d/ego4d_dataset.py; upstream
pytorchvideo/data/ego4d/ego4d_dataset.py: Ego4dImuData :38-147,
Ego4dMomentsDataset :149-625). One sample a labelled moment, through
``LabeledVideoDataset`` with a fixed-window clip sampler; IMU windows come
from one CSV a video; ``signal_transform`` is the audio front end that
makes audio-visual SlowFast's audio pathway.
"""

from __future__ import annotations

import csv
import json
import logging
import os
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Set, Tuple, Type

import numpy as np
import torch

from pytorchvideo_tpu_torch.data.clip_sampling import ClipSampler
from pytorchvideo_tpu_torch.data.ego4d.utils import (
    Ego4dImuDataBase,
    MomentsClipSampler,
    get_label_id_map,
)
from pytorchvideo_tpu_torch.data.labeled_video_dataset import LabeledVideoDataset
from pytorchvideo_tpu_torch.data.samplers import SequentialSampler

log = logging.getLogger("Ego4dMomentsDataset")

IMU_CHANNELS = ("accl_x", "accl_y", "accl_z", "gyro_x", "gyro_y", "gyro_z")


class Ego4dImuData(Ego4dImuDataBase):
    """One IMU CSV a video uid (``<imu_path>/<video_uid>.csv``):
    accelerometer and gyroscope x, y, z and ``canonical_timestamp_ms``. A
    window's "signal" (N, 6) and "timestamp" (N,) are float64 tensors."""

    def __init__(self, imu_path: str) -> None:
        super().__init__(imu_path)
        if not imu_path:
            raise ValueError("imu_path is empty")
        self.path_imu = imu_path
        self.IMU_by_video_uid: Dict[str, Any] = {}
        for f in os.listdir(self.path_imu):
            self.IMU_by_video_uid[f.split(".")[0]] = f.replace(".csv", "")
        self.imu_video_uid: Optional[str] = None
        self.imu_video_data = None

    def has_imu(self, video_uid: str) -> bool:
        return video_uid in self.IMU_by_video_uid

    def _load_imu(self, video_uid: str) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """The six channels standardised per channel (population std), the
        timestamps, and the rate in Hz; a negative rate (a device's broken
        clock) rebuilds the timestamps at 198 Hz. The CSV's statistics are
        numpy's float64 reductions on the host, so the windows equal the
        JAX package's bit for bit."""
        file_path = os.path.join(self.path_imu, video_uid) + ".csv"
        data_imu = defaultdict(list)
        with open(file_path, "r") as f:
            for row in csv.DictReader(f):
                for k, v in row.items():
                    data_imu[k].append(float(v) if v != "" else 0.0)
        signal = np.array([data_imu[k] for k in IMU_CHANNELS]).transpose()
        signal = (signal - signal.mean(axis=0)) / signal.std(axis=0)
        timestamps = np.array(data_imu["canonical_timestamp_ms"])
        sampling_rate = int(1000 / np.mean(np.diff(timestamps)))
        if sampling_rate < 0:
            timestamps = timestamps[0] + (1000 / 198) * np.arange(len(timestamps))
            sampling_rate = int(1000 / np.mean(np.diff(timestamps)))
        return torch.from_numpy(signal), torch.from_numpy(timestamps), sampling_rate

    def get_imu(self, video_uid: str):
        return self._load_imu(video_uid)

    def get_imu_sample(self, video_uid: str, video_start: float, video_end: float
                       ) -> Dict[str, Any]:
        """The samples whose timestamps lie in [video_start, video_end) s
        (the last sample left out where the window runs past the end); the
        video's data kept for the next call."""
        if not self.imu_video_uid or video_uid != self.imu_video_uid:
            self.imu_video_uid = video_uid
            self.imu_video_data = self._load_imu(video_uid)
        signal, timestamps, sampling_rate = self.imu_video_data
        bounds = torch.tensor([video_start * 1000, video_end * 1000], dtype=timestamps.dtype)
        start_id, end_id = torch.searchsorted(timestamps, bounds).tolist()
        if end_id == len(timestamps):
            end_id -= 1
        return {
            "timestamp": timestamps[start_id:end_id],
            "signal": signal[start_id:end_id],
            "sampling_rate": sampling_rate,
        }


N_FFT = 1024
HOP_LENGTH = 512
N_MELS = 256
MFCC_EPS = 1e-6


def _mel_filterbank(sample_rate: int, n_fft: int, n_mels: int) -> torch.Tensor:
    """The HTK mel filterbank (n_mels, n_fft // 2 + 1) in float64, as the
    JAX package builds it: triangles between mel points floored to FFT
    bins, so a row whose bins coincide stays empty (56 of 256 at 48 kHz
    and n_fft 1024)."""
    nyquist = torch.tensor(sample_rate / 2, dtype=torch.float64)
    top = 2595.0 * torch.log10(1.0 + nyquist / 700.0)
    mel_points = torch.linspace(0, float(top), n_mels + 2, dtype=torch.float64)
    hz_points = 700.0 * (10.0 ** (mel_points / 2595.0) - 1.0)
    bins = torch.floor((n_fft + 1) * hz_points / sample_rate)
    left, centre, right = bins[:-2, None], bins[1:-1, None], bins[2:, None]
    k = torch.arange(n_fft // 2 + 1, dtype=torch.float64)[None, :]
    rise = (k - left) / (centre - left).clamp(min=1)
    fall = (right - k) / (right - centre).clamp(min=1)
    fb = torch.where((k >= left) & (k < centre), rise, torch.zeros((), dtype=torch.float64))
    return torch.where((k >= centre) & (k < right), fall, fb)


def _dct_basis(n: int) -> torch.Tensor:
    """The DCT-II basis (n, n) over the mel axis, float64:
    ``cos(pi / n * (i + 0.5) * k)`` at row i, column k."""
    i = torch.arange(n, dtype=torch.float64)[:, None]
    k = torch.arange(n, dtype=torch.float64)[None, :]
    return torch.cos(torch.pi / n * (i + 0.5) * k)


def signal_transform(type: str = "spectrogram", sample_rate: int = 48000
                     ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The audio front end (upstream ego4d_dataset.py:544-597): a waveform
    (any shape, flattened; a tensor or an array) to its power spectrogram
    (513, frames), its mel spectrogram (256, frames) or its MFCCs (256,
    frames), computed on the waveform's device in its dtype (an array as
    a CPU tensor of its dtype). The STFT takes frames of 1024 samples every
    512 with a symmetric Hann window and no centring, as the JAX package's
    ``_stft_mag``: 1 + (N - 1024) // 512 frames."""
    if type not in ("spectrogram", "melspectrogram", "mfcc"):
        raise ValueError(type)
    tables = {"fb": _mel_filterbank(sample_rate, N_FFT, N_MELS), "dct": _dct_basis(N_MELS)}
    placed: Dict[Tuple[str, torch.device, torch.dtype], torch.Tensor] = {}

    def table(name: str, like: torch.Tensor) -> torch.Tensor:
        key = (name, like.device, like.dtype)
        if key not in placed:
            placed[key] = tables[name].to(device=like.device, dtype=like.dtype)
        return placed[key]

    def spectrogram(w) -> torch.Tensor:
        w = torch.as_tensor(w).reshape(-1)
        window = torch.hann_window(N_FFT, periodic=False, dtype=w.dtype, device=w.device)
        stft = torch.stft(w, n_fft=N_FFT, hop_length=HOP_LENGTH, window=window, center=False,
                          return_complex=True)
        return stft.abs() ** 2

    def melspectrogram(w) -> torch.Tensor:
        spec = spectrogram(w)
        return table("fb", spec) @ spec

    def mfcc(w) -> torch.Tensor:
        mel = torch.log(melspectrogram(w) + MFCC_EPS)
        return table("dct", mel).T @ mel

    return {"spectrogram": spectrogram, "melspectrogram": melspectrogram, "mfcc": mfcc}[type]


class Ego4dMomentsDataset(LabeledVideoDataset):
    """The moments benchmark: one sample a (clip, label span), its clip the
    span brought to ``window_sec`` (``MomentsClipSampler``). With
    ``decode_audio`` a sample's "audio" becomes {"signal", "spectrogram",
    "sampling_rate"} and "spectrogram" its ``audio_transform_type``; with
    ``imu`` its "imu" holds the clip's IMU window, on the device of the
    sample's audio (or else its video)."""

    VIDEO_FPS = 30
    AUDIO_FPS = 48000

    def __init__(
        self,
        annotation_path: str,
        metadata_path: str,
        split: Optional[str] = None,
        decode_audio: bool = False,
        decode_video: bool = True,
        imu: bool = False,
        clip_sampler: Optional[ClipSampler] = None,
        video_sampler: Type = SequentialSampler,
        transform: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None,
        decoder: str = "opencv",
        filtered_labels: Optional[List[str]] = None,
        window_sec: int = 10,
        audio_transform_type: str = "melspectrogram",
        imu_path: Optional[str] = None,
        label_id_map: Optional[Dict[str, int]] = None,
        label_id_map_path: Optional[str] = None,
        video_path_override: Optional[Callable[[str], str]] = None,
        eligible_video_uids: Optional[Set[str]] = None,
    ) -> None:
        if not (annotation_path and metadata_path):
            raise ValueError("annotation_path and metadata_path are both needed")
        if split not in ("train", "val", "test"):
            raise ValueError(f"bad split {split}")
        if (label_id_map is None) == (label_id_map_path is None):
            raise ValueError("give one of label_id_map and label_id_map_path")
        self.split = split
        self.training = split == "train"
        self.window_sec = window_sec
        self._transform_source = transform
        self.decode_audio_flag = decode_audio
        self.audio_transform_type = audio_transform_type
        # Built only for decoded audio: a bad type raises where audio is
        # transformed, as in the JAX package.
        self._audio_transform = (signal_transform(audio_transform_type, self.AUDIO_FPS)
                                 if decode_audio else None)

        with open(metadata_path, "r") as f:
            metadata = json.load(f)
        self.video_metadata_map = {x["video_uid"]: x for x in metadata["videos"]}
        with open(annotation_path, "r") as f:
            moments_annotations = json.load(f)

        self.label_name_id_map = (label_id_map if label_id_map
                                  else get_label_id_map(label_id_map_path))
        self.num_classes = len(self.label_name_id_map)

        self.imu_data: Optional[Ego4dImuDataBase] = None
        if imu:
            if not imu_path:
                raise ValueError("imu_path not provided")
            self.imu_data = Ego4dImuData(imu_path)

        samples = []
        for vid in moments_annotations["videos"]:
            video_uid = vid["video_uid"]
            if split and vid["split"] != split:
                continue
            if self.imu_data and not self.imu_data.has_imu(video_uid):
                continue
            if eligible_video_uids and video_uid not in eligible_video_uids:
                continue
            for clip in vid["clips"]:
                for vann in clip["annotations"]:
                    for lann in vann["labels"]:
                        label = lann["label"]
                        if lann["start_time"] == lann["end_time"]:
                            continue
                        if filtered_labels and label not in filtered_labels:
                            continue
                        meta = self.video_metadata_map[video_uid]
                        if meta.get("is_stereo"):
                            continue
                        video_path = (video_path_override(video_uid) if video_path_override
                                      else meta.get("manifold_path"))
                        if not video_path or label not in self.label_name_id_map:
                            continue
                        samples.append({
                            "clip_uid": clip["clip_uid"],
                            "video_uid": video_uid,
                            "duration": meta["duration_sec"],
                            "clip_video_start_sec": clip["video_start_sec"],
                            "clip_video_end_sec": clip["video_end_sec"],
                            "labels": [label],
                            "label_video_start_sec": lann["video_start_time"],
                            "label_video_end_sec": lann["video_end_time"],
                            "video_path": video_path,
                            "labels_id": self.label_name_id_map[label],
                        })
        self.cnt_samples = len(samples)
        log.info("Loaded %d ego4d moment samples", self.cnt_samples)

        if not clip_sampler:
            clip_sampler = MomentsClipSampler(self.window_sec)
        super().__init__([(x["video_path"], x) for x in samples], clip_sampler, video_sampler,
                         transform=self._transform_mm, decode_audio=decode_audio,
                         decode_video=decode_video, decoder=decoder)

    def convert_one_hot(self, label_list: List[str]) -> List[int]:
        one_hot = [0] * self.num_classes
        for lab in label_list:
            one_hot[self.label_name_id_map[lab]] = 1
        return one_hot

    def check_IMU(self, input_dict: Dict[str, Any]) -> bool:
        """True for a bad IMU window: not (N >= 200, 6)."""
        sig = input_dict["imu"]["signal"]
        return sig.ndim != 2 or sig.shape[0] < 200 or sig.shape[1] != 6

    def _transform_mm(self, sample_dict: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Adds the IMU window, the audio's spectrogram and the one-hot
        labels, then runs the user's transform; None (the sample skipped)
        for a bad IMU window."""
        video_uid = sample_dict["video_uid"]
        if sample_dict["video"] is None and self._decode_video:
            raise ValueError(f"{video_uid}: no video decoded")
        start, end = sample_dict["clip_start"], sample_dict["clip_end"]
        if not (start >= 0 and end >= start):
            raise ValueError(f"{video_uid}: bad clip [{start}, {end}]")
        audio = sample_dict.get("audio") if self.decode_audio_flag else None
        if audio is not None:
            audio = torch.as_tensor(audio)
        if self.imu_data:
            like = audio if audio is not None else sample_dict["video"]
            window = self.imu_data.get_imu_sample(video_uid, start, end)
            if torch.is_tensor(like):
                window = {k: v.to(like.device) if torch.is_tensor(v) else v
                          for k, v in window.items()}
            sample_dict["imu"] = window
            if self.check_IMU(sample_dict):
                log.warning("Bad IMU sample: ignoring: %s", video_uid)
                return None
        if audio is not None:
            sample_dict["audio"] = {
                "signal": audio,
                "spectrogram": self._audio_transform(audio),
                "sampling_rate": self.AUDIO_FPS,
            }
            sample_dict["spectrogram"] = sample_dict["audio"]["spectrogram"]
        sample_dict["labels_onehot"] = self.convert_one_hot(sample_dict["labels"])
        if self._transform_source:
            sample_dict = self._transform_source(sample_dict)
        return sample_dict
