# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: indexer.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rindexer.proto\x12\nindexer.v1\"R\n\x13GetPodScoresRequest\x12\x0e\n\x06prompt\x18\x01 \x01(\t\x12\x12\n\nmodel_name\x18\x02 \x01(\t\x12\x17\n\x0fpod_identifiers\x18\x03 \x03(\t\"<\n\x14GetPodScoresResponse\x12$\n\x06scores\x18\x01 \x03(\x0b\x32\x14.indexer.v1.PodScore\"&\n\x08PodScore\x12\x0b\n\x03pod\x18\x01 \x01(\t\x12\r\n\x05score\x18\x02 \x01(\x01\x32\x65\n\x0eIndexerService\x12S\n\x0cGetPodScores\x12\x1f.indexer.v1.GetPodScoresRequest\x1a .indexer.v1.GetPodScoresResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'indexer_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _GETPODSCORESREQUEST._serialized_start=29
  _GETPODSCORESREQUEST._serialized_end=111
  _GETPODSCORESRESPONSE._serialized_start=113
  _GETPODSCORESRESPONSE._serialized_end=173
  _PODSCORE._serialized_start=175
  _PODSCORE._serialized_end=213
  _INDEXERSERVICE._serialized_start=215
  _INDEXERSERVICE._serialized_end=316
# @@protoc_insertion_point(module_scope)
