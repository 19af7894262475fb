# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: tokenizer.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0ftokenizer.proto\x12\x0ctokenization\"P\n\x0fTokenizeRequest\x12\r\n\x05input\x18\x01 \x01(\t\x12\x12\n\nmodel_name\x18\x02 \x01(\t\x12\x1a\n\x12\x61\x64\x64_special_tokens\x18\x03 \x01(\x08\"c\n\x10TokenizeResponse\x12\x11\n\tinput_ids\x18\x01 \x03(\r\x12\x0f\n\x07success\x18\x02 \x01(\x08\x12\x15\n\rerror_message\x18\x03 \x01(\t\x12\x14\n\x0coffset_pairs\x18\x04 \x03(\r\"?\n\x10\x43onversationTurn\x12+\n\x08messages\x18\x01 \x03(\x0b\x32\x19.tokenization.ChatMessage\",\n\x0b\x43hatMessage\x12\x0c\n\x04role\x18\x01 \x01(\t\x12\x0f\n\x07\x63ontent\x18\x02 \x01(\t\"\x8a\x01\n\x0fToolDescription\x12\x35\n\x04tool\x18\x01 \x03(\x0b\x32\'.tokenization.ToolDescription.ToolEntry\x1a@\n\tToolEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\"\n\x05value\x18\x02 \x01(\x0b\x32\x13.tokenization.Value:\x02\x38\x01\"\x88\x01\n\x08\x44ocument\x12\x36\n\x08\x64ocument\x18\x01 \x03(\x0b\x32$.tokenization.Document.DocumentEntry\x1a\x44\n\rDocumentEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\"\n\x05value\x18\x02 \x01(\x0b\x32\x13.tokenization.Value:\x02\x38\x01\"\xcd\x01\n\x05Value\x12\x16\n\x0cstring_value\x18\x01 \x01(\tH\x00\x12\x16\n\x0cnumber_value\x18\x02 \x01(\x01H\x00\x12\x14\n\nbool_value\x18\x03 \x01(\x08H\x00\x12-\n\nlist_value\x18\x04 \x01(\x0b\x32\x17.tokenization.ListValueH\x00\x12\x31\n\x0cstruct_value\x18\x05 \x01(\x0b\x32\x19.tokenization.StructValueH\x00\x12\x13\n\tint_value\x18\x06 \x01(\x12H\x00\x42\x07\n\x05value\"0\n\tListValue\x12#\n\x06values\x18\x01 \x03(\x0b\x32\x13.tokenization.Value\"\x88\x01\n\x0bStructValue\x12\x35\n\x06\x66ields\x18\x01 \x03(\x0b\x32%.tokenization.StructValue.FieldsEntry\x1a\x42\n\x0b\x46ieldsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\"\n\x05value\x18\x02 \x01(\x0b\x32\x13.tokenization.Value:\x02\x38\x01\"\xe3\x03\n\x13\x43hatTemplateRequest\x12:\n\x12\x63onversation_turns\x18\x01 \x03(\x0b\x32\x1e.tokenization.ConversationTurn\x12,\n\x05tools\x18\x02 \x03(\x0b\x32\x1d.tokenization.ToolDescription\x12)\n\tdocuments\x18\x03 \x03(\x0b\x32\x16.tokenization.Document\x12\x15\n\rchat_template\x18\x04 \x01(\t\x12$\n\x1creturn_assistant_tokens_mask\x18\x05 \x01(\x08\x12\x1e\n\x16\x63ontinue_final_message\x18\x06 \x01(\x08\x12\x1d\n\x15\x61\x64\x64_generation_prompt\x18\x07 \x01(\x08\x12W\n\x14\x63hat_template_kwargs\x18\x08 \x03(\x0b\x32\x39.tokenization.ChatTemplateRequest.ChatTemplateKwargsEntry\x12\x12\n\nmodel_name\x18\t \x01(\t\x1aN\n\x17\x43hatTemplateKwargsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\"\n\x05value\x18\x02 \x01(\x0b\x32\x13.tokenization.Value:\x02\x38\x01\"W\n\x14\x43hatTemplateResponse\x12\x17\n\x0frendered_prompt\x18\x01 \x01(\t\x12\x0f\n\x07success\x18\x02 \x01(\x08\x12\x15\n\rerror_message\x18\x03 \x01(\t\"h\n\x1aInitializeTokenizerRequest\x12\x12\n\nmodel_name\x18\x01 \x01(\t\x12\x17\n\x0f\x65nable_thinking\x18\x02 \x01(\x08\x12\x1d\n\x15\x61\x64\x64_generation_prompt\x18\x03 \x01(\x08\"E\n\x1bInitializeTokenizerResponse\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12\x15\n\rerror_message\x18\x02 \x01(\t2\xa9\x02\n\x13TokenizationService\x12I\n\x08Tokenize\x12\x1d.tokenization.TokenizeRequest\x1a\x1e.tokenization.TokenizeResponse\x12[\n\x12RenderChatTemplate\x12!.tokenization.ChatTemplateRequest\x1a\".tokenization.ChatTemplateResponse\x12j\n\x13InitializeTokenizer\x12(.tokenization.InitializeTokenizerRequest\x1a).tokenization.InitializeTokenizerResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'tokenizer_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TOOLDESCRIPTION_TOOLENTRY._options = None
  _TOOLDESCRIPTION_TOOLENTRY._serialized_options = b'8\001'
  _DOCUMENT_DOCUMENTENTRY._options = None
  _DOCUMENT_DOCUMENTENTRY._serialized_options = b'8\001'
  _STRUCTVALUE_FIELDSENTRY._options = None
  _STRUCTVALUE_FIELDSENTRY._serialized_options = b'8\001'
  _CHATTEMPLATEREQUEST_CHATTEMPLATEKWARGSENTRY._options = None
  _CHATTEMPLATEREQUEST_CHATTEMPLATEKWARGSENTRY._serialized_options = b'8\001'
  _TOKENIZEREQUEST._serialized_start=33
  _TOKENIZEREQUEST._serialized_end=113
  _TOKENIZERESPONSE._serialized_start=115
  _TOKENIZERESPONSE._serialized_end=214
  _CONVERSATIONTURN._serialized_start=216
  _CONVERSATIONTURN._serialized_end=279
  _CHATMESSAGE._serialized_start=281
  _CHATMESSAGE._serialized_end=325
  _TOOLDESCRIPTION._serialized_start=328
  _TOOLDESCRIPTION._serialized_end=466
  _TOOLDESCRIPTION_TOOLENTRY._serialized_start=402
  _TOOLDESCRIPTION_TOOLENTRY._serialized_end=466
  _DOCUMENT._serialized_start=469
  _DOCUMENT._serialized_end=605
  _DOCUMENT_DOCUMENTENTRY._serialized_start=537
  _DOCUMENT_DOCUMENTENTRY._serialized_end=605
  _VALUE._serialized_start=608
  _VALUE._serialized_end=813
  _LISTVALUE._serialized_start=815
  _LISTVALUE._serialized_end=863
  _STRUCTVALUE._serialized_start=866
  _STRUCTVALUE._serialized_end=1002
  _STRUCTVALUE_FIELDSENTRY._serialized_start=936
  _STRUCTVALUE_FIELDSENTRY._serialized_end=1002
  _CHATTEMPLATEREQUEST._serialized_start=1005
  _CHATTEMPLATEREQUEST._serialized_end=1488
  _CHATTEMPLATEREQUEST_CHATTEMPLATEKWARGSENTRY._serialized_start=1410
  _CHATTEMPLATEREQUEST_CHATTEMPLATEKWARGSENTRY._serialized_end=1488
  _CHATTEMPLATERESPONSE._serialized_start=1490
  _CHATTEMPLATERESPONSE._serialized_end=1577
  _INITIALIZETOKENIZERREQUEST._serialized_start=1579
  _INITIALIZETOKENIZERREQUEST._serialized_end=1683
  _INITIALIZETOKENIZERRESPONSE._serialized_start=1685
  _INITIALIZETOKENIZERRESPONSE._serialized_end=1754
  _TOKENIZATIONSERVICE._serialized_start=1757
  _TOKENIZATIONSERVICE._serialized_end=2054
# @@protoc_insertion_point(module_scope)
